"""The numerics layer's certified invariants, held on the port (twins of
``tests/system/test_numerics_property.py``).

The reference draws its inputs with hypothesis; each twin draws the same
kind of input from a seeded numpy generator, feeds it through the
reference's op and the port's (the plain versions on the CPU), and checks:

* exp_neg, recip, rsqrt: the port meets the reference's certified bound
  against float64 truth, and equals the reference within its CPU
  ``exp2`` error at the power of two the glue scales by (exact in the
  port; ROADMAP queue 3, held differences) plus one float32 rounding;
* softmax: a probability distribution whose argmax survives any margin
  above 0.01, within ``softmax_ulp_bound()`` of the reference;
* the one-table read (``table_eval``): bitwise the reference's
  interpret-mode kernel and its int64 oracle;
* silu and softplus: within 2e-2 of the exact functions and 1e-6
  (relative) of the reference.

Both packages' default Explorers run on fresh cache directories.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import api as jax_api
from repro.kernels.interp.ops import table_eval as jax_table_eval
from repro.numerics import ops as jops
from repro.numerics.registry import get_table as jax_get_table
from repro_torch import api
from repro_torch.api import Explorer, ExploreConfig
from repro_torch.kernels.interp.ops import table_eval
from repro_torch.kernels.interp.ref import LOG2E
from repro_torch.numerics import ops
from repro_torch.numerics.registry import get_table

f32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fresh_default_sessions(tmp_path_factory):
    old, jold = api.default_explorer(), jax_api.default_explorer()
    api.set_default_explorer(Explorer(ExploreConfig(
        device="cpu", cache_dir=str(tmp_path_factory.mktemp("port")))))
    jax_api.set_default_explorer(jax_api.Explorer(jax_api.ExploreConfig(
        cache_dir=str(tmp_path_factory.mktemp("ref")))))
    yield
    api.set_default_explorer(old)
    jax_api.set_default_explorer(jold)


def _exp2_err(e: np.ndarray) -> np.ndarray:
    """Relative error of the reference's CPU float32 ``exp2`` at the
    integers -e (exact powers of two in the port)."""
    got = np.asarray(jnp.exp2(-jnp.asarray(e, jnp.float32)), np.float64)
    exact = np.ldexp(1.0, -e.astype(np.int64))
    return np.abs(got - exact) / exact


def _pow2_rtol(fn: str, x: np.ndarray) -> np.ndarray:
    """The port's tolerance against the reference for ``fn`` at float32
    ``x``: the reference's exp2 error at the glue's power of two plus one
    float32 rounding."""
    if fn == "exp_neg":
        t = np.minimum(np.maximum(-x, 0).astype(f32) * f32(LOG2E),
                       f32(126.0))
        k = np.floor(t)
    else:
        _, e = np.frexp(x.astype(f32))
        k = e - 1 if fn == "recip_pos" else np.where(e % 2, e - 1,
                                                     e - 2) // 2
    return _exp2_err(k) + 2.0 ** -24


def _draws(seed: int, lo: float, hi: float, examples: int = 30):
    """``examples`` lists of 1-64 float32 values in [lo, hi] (log-uniform
    for a positive range: the reference's draws reach every binade),
    concatenated: the ops are elementwise, so one call of each package
    checks every list (the reference compiles once per shape)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(examples):
        n = int(rng.integers(1, 65))
        if lo > 0:
            x = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
        else:
            x = rng.uniform(lo, hi, n)
        out.append(np.clip(x.astype(f32), f32(lo), f32(hi)))
    return np.concatenate(out)


def _both(fn: str, x: np.ndarray):
    got = getattr(ops, f"approx_{fn}")(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jops, f"approx_{fn}")(jnp.asarray(x)))
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= _pow2_rtol(fn, x) * np.abs(want) + 1e-30), fn
    return got.astype(np.float64)


def test_exp_neg_certified_bound():
    d = get_table("exp2neg")
    assert d.to_dict() == jax_get_table("exp2neg").to_dict()
    bound = 2.0 ** -d.out_bits * 4 + np.log(2) * 2.0 ** -d.in_bits
    x = _draws(0, -80.0, 0.0)
    got = _both("exp_neg", x)
    want = np.exp(x.astype(np.float64))
    assert np.all(np.abs(got - want)
                  <= bound * np.maximum(want, 1e-300) + 1e-38)
    assert np.all(got >= 0.0)


def test_recip_certified_bound():
    d = get_table("recip")
    assert d.to_dict() == jax_get_table("recip").to_dict()
    bound = 2.0 ** -d.in_bits * 2
    x = _draws(1, float(f32(1e-8)), float(f32(1e30)))
    got = _both("recip_pos", x)
    want = 1.0 / x.astype(np.float64)
    assert np.all(np.abs(got - want) <= bound * want)


def test_rsqrt_certified_bound():
    d = get_table("rsqrt")
    assert d.to_dict() == jax_get_table("rsqrt").to_dict()
    bound = 2.0 ** -(d.in_bits - 2)
    x = _draws(2, float(f32(1e-8)), float(f32(1e30)))
    got = _both("rsqrt_pos", x)
    want = 1.0 / np.sqrt(x.astype(np.float64))
    assert np.all(np.abs(got - want) <= bound * want)


def test_softmax_is_distribution():
    """20 seeded (rows, cols) draws of normal * 8, rows 1-7; the rows of
    the draws that share a width go through one call of each package."""
    rng = np.random.default_rng(3)
    by_cols: dict[int, list] = {}
    for _ in range(20):
        rows, cols = int(rng.integers(1, 8)), int(rng.choice([2, 5, 17, 33]))
        by_cols.setdefault(cols, []).append(
            (rng.standard_normal((rows, cols)) * 8).astype(f32))
    for cols, xs in sorted(by_cols.items()):
        x = np.concatenate(xs)
        p = ops.approx_softmax(torch.from_numpy(x)).numpy().astype(np.float64)
        want = np.asarray(jops.approx_softmax(jnp.asarray(x)))
        np.testing.assert_allclose(p, want, atol=1e-30,
                                   rtol=ops.softmax_ulp_bound())
        assert np.all(p >= 0)
        np.testing.assert_allclose(p.sum(-1), 1.0, atol=5e-3)
        xf = x.astype(np.float64)
        top2 = np.sort(xf, -1)[:, -2:]
        margin_ok = (top2[:, 1] - top2[:, 0]) > 0.01
        assert np.all(p.argmax(-1)[margin_ok] == xf.argmax(-1)[margin_ok])


def test_interp_kernel_matches_int_oracle():
    """The one-table read on the CPU (``interp_eval``'s plain version)
    bitwise the reference's interpret-mode kernel and its int64 path."""
    d, jd = get_table("silu"), jax_get_table("silu")
    assert d.to_dict() == jd.to_dict()
    rng = np.random.default_rng(4)
    codes = np.concatenate([
        rng.integers(0, 1 << d.in_bits, int(rng.integers(1, 201)),
                     dtype=np.int32) for _ in range(25)])
    got = table_eval(torch.from_numpy(codes), d).numpy()
    jc = jnp.asarray(codes)
    np.testing.assert_array_equal(got, np.asarray(jax_table_eval(
        jc, jd, use_kernel=True, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_table_eval(
        jc, jd, use_kernel=False)))


def test_silu_gelu_softplus_pointwise():
    rng = np.random.default_rng(5)
    for _ in range(10):
        x = rng.uniform(-12, 12, 256).astype(f32)
        for name, exact in (("silu", F.silu), ("softplus", F.softplus)):
            got = getattr(ops, f"approx_{name}")(torch.from_numpy(x)).numpy()
            want = np.asarray(getattr(jops, f"approx_{name}")(
                jnp.asarray(x)))
            assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-30)
            ref = exact(torch.from_numpy(x).double()).numpy()
            assert np.max(np.abs(got - ref)) < 2e-2, name
