"""The MoE block (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the ``deepseek_moe_16b`` smoke config with the
reference's parameters, and mirrors of ``tests/models/test_moe.py``.

Routing is compared tie-aware. Router probabilities may differ between the
packages by float32 reassociation (exact numerics: atol 1e-6) or by one
table step (interp-fused: relative ``softmax_ulp_bound``), so the top-k
expert ids must be equal wherever the reference's gap between its k-th and
(k+1)-th probability exceeds twice that tolerance, and most tokens must
route clear of it. A token's dispatch slot depends on the assignments of
the tokens before it in its example, so outputs are compared on the tokens
whose example routed identically up to and including them: exact numerics
atol 1e-5 (float32 reassociation of the expert products), interp-fused
4 * 2^-12 * max|y| (a few silu table-code flips), as the model tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models.layers import init_tree
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import MoEConfig, get_smoke_config
from repro_torch.models import moe
from repro_torch.numerics.ops import (ExactNumerics, PlainFusedNumerics,
                                      get_numerics, softmax_ulp_bound)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("deepseek_moe_16b")
    cfg = get_smoke_config("deepseek_moe_16b")
    jp = init_tree(jax.random.key(0), jmoe.moe_shapes(jcfg))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, p=p,
                jlib=default_explorer().compile(),
                lib=InterpLibrary.default_library("cpu"))


def _numerics(s, name):
    interp = name != "exact"
    return (jax_get_numerics(name, s["jlib"] if interp else None),
            get_numerics(name, s["lib"] if interp else None))


@pytest.mark.parametrize("shape", [(2, 16), (3, 24)])
@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_moe_block_matches_reference(name, shape, setup):
    s = setup
    jnum, tnum = _numerics(s, name)
    k = s["cfg"].moe.top_k
    x = np.random.default_rng(shape[1]).standard_normal(
        shape + (s["cfg"].d_model,)).astype(np.float32)
    jy, jprobs = jmoe.moe_block(s["jp"], jnp.asarray(x), s["jcfg"], jnum,
                                return_probs=True)
    y, probs = moe.moe_block(s["p"], torch.from_numpy(x), s["cfg"], tnum,
                             return_probs=True)
    jy, jprobs = np.asarray(jy), np.asarray(jprobs)
    if name == "exact":
        p_tol, y_tol = 1e-6, 1e-5
        np.testing.assert_allclose(probs.numpy(), jprobs, rtol=0, atol=p_tol)
    else:
        rel = softmax_ulp_bound(s["lib"].meta("exp2neg"),
                                s["lib"].meta("recip"))
        p_tol, y_tol = rel * jprobs.max(), 4 * 2.0 ** -12 * np.abs(jy).max()
        assert np.all(np.abs(probs.numpy() - jprobs)
                      <= rel * jprobs + 1e-30)
    # routing: ids equal wherever the k-th / (k+1)-th gap is clear
    jidx = np.asarray(jax.lax.top_k(jnp.asarray(jprobs), k)[1])
    _, idx = moe.top_k(probs, k)
    srt = np.sort(jprobs, -1)[..., ::-1]
    clear = srt[..., k - 1] - srt[..., k] > 2 * p_tol
    assert clear.mean() >= 0.9
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1)[clear],
                                  np.sort(jidx, -1)[clear])
    # outputs where the example routed identically so far
    same = np.cumprod(np.all(idx.numpy() == jidx, -1), axis=1).astype(bool)
    assert same[:, 0].all()
    np.testing.assert_allclose(y.numpy()[same], jy[same], rtol=0,
                               atol=y_tol)


def test_planted_ties_pick_lower_index(setup):
    """Quantized probabilities tie exactly; like ``jax.lax.top_k`` the port
    takes the lower expert index first. Directly on tied values, and
    through the router with duplicated expert columns (equal logits, so
    equal probabilities under every backend)."""
    rng = np.random.default_rng(0)
    probs = (rng.integers(0, 4, (64, 16)) / 8).astype(np.float32)
    vals, idx = moe.top_k(torch.from_numpy(probs), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))

    s = setup
    cfg = s["cfg"]
    router = np.array(s["jp"]["router"])
    router[:, 1::2] = router[:, :1]  # odd experts tie with expert 0
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    for num in (ExactNumerics(), PlainFusedNumerics(s["lib"])):
        probs, idx, _ = moe.route({"router": torch.from_numpy(router)},
                                  torch.from_numpy(x), cfg, num)
        ties = probs.numpy()[..., 1::2]
        assert np.all(ties == probs.numpy()[..., :1])
        jidx = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()),
                                        cfg.moe.top_k)[1])
        np.testing.assert_array_equal(idx.numpy(), jidx)
        assert np.any(np.all(idx.numpy()[..., :3] == [0, 1, 3], -1))  # ties


# -- mirrors of tests/models/test_moe.py ------------------------------------

def _mirror(n_experts=4, top_k=2, cap_factor=1.25, d=32, d_e=48,
            n_shared=0, seed=0):
    """The reference test's small MoE: config and numpy-made parameters
    (truncated-normal-like scale 1/sqrt(fan_in))."""
    cfg = get_smoke_config("deepseek_moe_16b").replace(
        d_model=d, moe=MoEConfig(n_experts=n_experts, top_k=top_k,
                                 d_expert=d_e, n_shared=n_shared,
                                 capacity_factor=cap_factor))
    rng = np.random.default_rng(seed)
    p = {name: torch.from_numpy(
            (np.clip(rng.standard_normal(sp.shape), -2, 2)
             / np.sqrt(sp.shape[-2])).astype(np.float32))
         for name, sp in moe.moe_shapes(cfg).items()}
    return cfg, p


def _x(shape, d, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32))


def test_moe_output_shape_and_finite():
    cfg, p = _mirror()
    x = _x((3, 16), cfg.d_model, 1)
    y, probs = moe.moe_block(p, x, cfg, ExactNumerics(), return_probs=True)
    assert y.shape == x.shape and probs.shape == (3, 16, 4)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


def test_moe_batch_independence():
    """Per-example dispatch: example i's output does not depend on
    example j."""
    cfg, p = _mirror()
    xa, xb = _x((2, 16), cfg.d_model, 2), _x((2, 16), cfg.d_model, 3)
    y_both = moe.moe_block(p, torch.cat([xa, xb]), cfg, ExactNumerics())
    y_a = moe.moe_block(p, xa, cfg, ExactNumerics())
    np.testing.assert_allclose(y_both[:2].numpy(), y_a.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_moe_capacity_drops_tokens():
    """capacity_factor << 1 overflows most copies: the output stays finite
    and is strictly smaller than with ample capacity."""
    cfg, p = _mirror(cap_factor=0.1)
    x = _x((1, 64), cfg.d_model, 4)
    y = moe.moe_block(p, x, cfg, ExactNumerics())
    assert torch.isfinite(y).all()
    cfg2 = cfg.replace(moe=MoEConfig(n_experts=4, top_k=2, d_expert=48,
                                     capacity_factor=4.0))
    y2 = moe.moe_block(p, x, cfg2, ExactNumerics())
    assert float(torch.linalg.norm(y)) < float(torch.linalg.norm(y2))


def test_moe_capacity_ample_uses_all_topk():
    """With ample capacity the output is the dense mixture of the top-k
    experts, weighted by the renormalized gates."""
    cfg, p = _mirror(cap_factor=8.0)
    x = _x((1, 8), cfg.d_model, 5)
    y = moe.moe_block(p, x, cfg, ExactNumerics())
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], -1)
    gate, idx = moe.top_k(probs, cfg.moe.top_k)
    gate = gate / gate.sum(-1, keepdim=True)
    h = torch.einsum("td,edf->tef", xt, p["wi"])
    g, u = torch.chunk(h, 2, -1)
    eo = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u,
                      p["wo"])
    ref = torch.einsum("tk,tkd->td", gate,
                       torch.gather(eo, 1, idx[..., None].expand(
                           -1, -1, cfg.d_model)))
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), rtol=2e-2, atol=2e-3)


def test_shared_experts_added():
    cfg, _ = _mirror()
    cfg_sh, p_sh = _mirror(n_shared=1)
    x = _x((1, 8), cfg.d_model, 6)
    y0 = moe.moe_block(p_sh, x, cfg, ExactNumerics())
    y1 = moe.moe_block(p_sh, x, cfg_sh, ExactNumerics())
    assert float((y1 - y0).abs().max()) > 1e-4
