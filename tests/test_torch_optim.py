"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim``: one AdamW update from a carried-over state (master, mu
and nu within one float32 ulp, the bf16 parameters bitwise), the global
norm, the cosine schedule at warm-up, peak and end, the int8 compression
payload bitwise, and the reference's four optimizer substrate checks
(``tests/system/test_substrate.py``) on the port.

The one-ulp bound: each update is the reference's elementwise float32
expression in the reference's order, but the bias corrections' ``pow``
and the global norm's sum order are each library's own.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWState as JAdamWState
from repro.optim.adamw import adamw_state_shapes as jax_adamw_state_shapes
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import global_norm as jax_global_norm
from repro.optim.compress import compress_grads as jax_compress_grads
from repro.optim.compress import compress_state_shapes as jax_compress_shapes
from repro.optim.schedule import cosine_schedule as jax_cosine_schedule
from repro_torch.models.layers import Spec
from repro_torch.optim import (AdamWState, adamw_init, adamw_state_shapes,
                               adamw_update, compress_grads, compress_init,
                               compress_state_shapes, cosine_schedule,
                               decompress_grads, global_norm)
from repro_torch.util.tree import leaves_with_paths, tree_map


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _state(seed: int, grad_scale: float):
    """A carried-over state (step 3, random master / mu and positive nu)
    and bf16 gradients, in both packages: matrices (decayed), a vector and
    a rank-3 leaf, nested under unsorted keys."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "blk": {"z": (2, 3, 4), "a": (7,)}}

    def draw(scale, positive=False):
        def one(shape):
            x = rng.standard_normal(shape).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return {"w": one(shapes["w"]), "b": one(shapes["b"]),
                "blk": {"z": one(shapes["blk"]["z"]),
                        "a": one(shapes["blk"]["a"])}}

    master, mu, nu = draw(1.0), draw(0.1), draw(0.01, positive=True)
    grads = draw(grad_scale)
    grads_bf = tree_map(lambda a: _bf16(a), grads)
    tstate = AdamWState(torch.tensor(3, dtype=torch.int32),
                        *(tree_map(torch.from_numpy, t)
                          for t in (master, mu, nu)))
    jstate = JAdamWState(jnp.asarray(3, jnp.int32),
                         *(jax.tree.map(jnp.asarray, t)
                           for t in (master, mu, nu)))
    jgrads = tree_map(lambda t: jnp.asarray(_np(t)).astype(jnp.bfloat16),
                      grads_bf)
    return tstate, grads_bf, jstate, jgrads


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ai = a.astype(np.float32).view(np.int32).astype(np.int64)
    bi = b.astype(np.float32).view(np.int32).astype(np.int64)
    assert (np.sign(a) == np.sign(b)).all() or np.abs(a - b).max() == 0
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("grad_scale", [0.05, 3.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    """One update at lr 1e-3, weight decay 0.1 on the rank >= 2 leaves:
    master / mu / nu within one float32 ulp of the reference's, the bf16
    parameters bitwise, grad_norm at rtol 1e-6, the step counter 4."""
    tstate, grads, jstate, jgrads = _state(0, grad_scale)
    lr = 1e-3
    params, st, m = adamw_update(grads, tstate, torch.tensor(lr))
    jparams, jst, jm = jax_adamw_update(jgrads, jstate, jnp.asarray(lr))
    assert int(st.step) == int(jst.step) == 4 and st.step.dtype == \
        torch.int32
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert (float(m["grad_norm"]) > 1.0) == (grad_scale > 1)
    for tree, jtree in ((st.master, jst.master), (st.mu, jst.mu),
                        (st.nu, jst.nu)):
        jl = dict(leaves_with_paths(jtree))
        for name, t in leaves_with_paths(tree):
            assert t.dtype == torch.float32
            assert _ulps(t.numpy(), np.asarray(jl[name])) <= 1, name
    jl = dict(leaves_with_paths(jparams))
    for name, t in leaves_with_paths(params):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _np(t), np.asarray(jl[name]).astype(np.float32), err_msg=name)


def test_adamw_donate_is_the_same_update():
    """``donate=True`` writes the new master and moments into the state's
    own tensors, with the values of the functional update."""
    tstate, grads, _, _ = _state(1, 0.5)
    fresh = AdamWState(tstate.step, *(tree_map(torch.clone, t)
                                      for t in tstate[1:]))
    p1, s1, _ = adamw_update(grads, tstate, torch.tensor(2e-3))
    master_w = fresh.master["w"]
    p2, s2, _ = adamw_update(grads, fresh, torch.tensor(2e-3), donate=True)
    assert s2.master["w"] is master_w  # written in place
    for a, b in zip(leaves_with_paths((p1, s1)), leaves_with_paths((p2, s2))):
        assert a[0] == b[0]
        assert torch.equal(a[1], b[1]), a[0]


def test_global_norm_and_state_shapes():
    tstate, grads, jstate, jgrads = _state(2, 1.0)
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(jax_global_norm(jgrads)), rtol=1e-6)
    shapes = {"a": Spec((3, 4), torch.bfloat16), "b": Spec((4,),
                                                         torch.bfloat16)}
    jshapes = {"a": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16),
               "b": jax.ShapeDtypeStruct((4,), jnp.bfloat16)}
    got = leaves_with_paths((adamw_state_shapes(shapes),
                             compress_state_shapes(shapes)))
    want = leaves_with_paths((jax_adamw_state_shapes(jshapes),
                              jax_compress_shapes(jshapes)))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, sp), (_, jsp) in zip(got, want):
        assert sp.shape == tuple(jsp.shape)
        assert str(sp.dtype).split(".")[-1] == str(jsp.dtype)


@pytest.mark.parametrize("step", [0, 3, 10, 11, 55, 100, 140])
def test_cosine_schedule_matches_reference(step):
    """Warm-up (0, 3), peak (10), the decay (11, 55), the end (100) and
    past it (140), float32 bitwise."""
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    got = cosine_schedule(step, **kw)
    want = np.asarray(jax_cosine_schedule(step, **kw))
    assert got.dtype == torch.float32 and got.shape == ()
    assert _ulps(np.asarray(got.numpy()), want) == 0


def test_compression_payload_bitwise():
    """Three steps of error-feedback compression carried in both
    packages: int8 payload and scales bitwise every step, residual within
    one ulp (a product and a subtract of equal operands)."""
    rng = np.random.default_rng(4)
    res = compress_init({"w": torch.zeros(64), "v": torch.zeros(3, 5)})
    jres = jax.tree.map(lambda t: jnp.asarray(t.numpy()), res)
    for _ in range(3):
        g = {"w": rng.standard_normal(64).astype(np.float32),
             "v": (rng.standard_normal((3, 5)) * 1e-3).astype(np.float32)}
        q, s, res = compress_grads(tree_map(torch.from_numpy, g), res)
        jq, js, jres = jax_compress_grads(jax.tree.map(jnp.asarray, g), jres)
        for k in g:
            assert q[k].dtype == torch.int8
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            assert float(s[k]) == float(js[k])
            assert _ulps(res[k].numpy(), np.asarray(jres[k])) <= 1
    # round half to even, as jnp.round: 2.5 -> 2, 3.5 -> 4 (scale 1)
    q, _, _ = compress_grads({"x": torch.tensor([2.5, 3.5, -2.5, 127.0])},
                             {"x": torch.zeros(4)})
    assert q["x"].tolist() == [2, 4, -2, 127]


# ---- the reference's optimizer substrate checks, on the port -------------

def test_adamw_descends_quadratic():
    w = {"w": torch.tensor([3.0, -2.0])}
    st = adamw_init(w)
    params = w
    for _ in range(200):
        g = {"w": 2 * st.master["w"]}  # d/dw of ||w||^2
        params, st, _ = adamw_update(g, st, torch.tensor(0.05),
                                     weight_decay=0.0,
                                     param_dtype=torch.float32)
    assert float(global_norm(params)) < 0.05


def test_adamw_master_weights_fp32():
    w = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(w)
    assert st.master["w"].dtype == torch.float32
    assert st.master["w"].data_ptr() != w["w"].data_ptr()
    p, st2, _ = adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)}, st,
                             torch.tensor(1e-3))
    assert p["w"].dtype == torch.bfloat16
    assert st2.master["w"].dtype == torch.float32


def test_schedule_warmup_and_decay():
    lr0 = float(cosine_schedule(0, peak_lr=1.0, warmup=10, total=100))
    lrw = float(cosine_schedule(10, peak_lr=1.0, warmup=10, total=100))
    lre = float(cosine_schedule(100, peak_lr=1.0, warmup=10, total=100))
    assert lr0 == 0.0 and abs(lrw - 1.0) < 1e-6 and abs(lre - 0.1) < 1e-6


def test_compression_error_feedback_telescopes():
    """The sum of dequantized gradients over T steps equals the sum of the
    true ones to within the residual."""
    gen = torch.Generator().manual_seed(0)
    g_true = [{"w": torch.randn(64, generator=gen)} for _ in range(20)]
    res = compress_init(g_true[0])
    acc_q, acc_t = torch.zeros(64), torch.zeros(64)
    for g in g_true:
        payload, scales, res = compress_grads(g, res)
        acc_q = acc_q + decompress_grads(payload, scales)["w"]
        acc_t = acc_t + g["w"]
    err = float(torch.max(torch.abs(acc_q + res["w"] - acc_t)))
    assert err < 1e-4, err
