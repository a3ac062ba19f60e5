"""The library-bound fused RMSNorm: the port's plain version against the
reference oracle and the reference kernel in interpret mode.

Tolerance: where mean(x^2) agrees bitwise between the two frameworks the
table codes are equal, so the outputs may differ only by the reference's
float32 ``exp2`` of an integer (inexact on the CPU by a few f32 ulps; the
port takes exact powers of two): rtol 1e-6. Elsewhere the summation order
may move mean(x^2) across a code boundary: at most 2 rsqrt-table ulps, and a
table output lies in (2^(out_bits-1), 2^out_bits], so rtol 2 * 2^-(out_bits-1).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.kernels.rmsnorm.kernel import fused_rmsnorm_lib
from repro.kernels.rmsnorm.ref import fused_rmsnorm_lib_ref
from repro.kernels.softmax.ops import lib_meta as jax_lib_meta
from repro_torch.api.library import InterpLibrary
from repro_torch.kernels.interp.ops import lib_meta
from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library
from repro_torch.kernels.rmsnorm.ref import rsqrt_codes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

EPS = 1e-6


@pytest.fixture(scope="module")
def libs():
    return InterpLibrary.default_library("cpu"), default_explorer().compile()


def _inputs(seed=0, rows=8, d=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32) * \
        rng.uniform(0.05, 20.0, (rows, 1)).astype(np.float32)
    # rows of small powers of two: x^2 and every partial sum are exact, so
    # both frameworks agree on mean(x^2) bitwise whatever their sum order
    x[:3] = rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], (3, d))
    gamma = rng.uniform(0.5, 1.5, d).astype(np.float32)
    return x, gamma


def _ms_both(x):
    ms_t = (torch.from_numpy(x) ** 2).mean(-1) + EPS
    ms_j = np.asarray(jnp.mean(jnp.asarray(x) ** 2, -1) + EPS)
    return ms_t.numpy(), ms_j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(dtype, libs):
    lib, jlib = libs
    x, gamma = _inputs()
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    got = approx_rmsnorm_library(xt, torch.from_numpy(gamma), lib,
                                 EPS).float().numpy()
    want = np.asarray(fused_rmsnorm_lib_ref(
        xj, jnp.asarray(gamma), jlib.coeffs, jax_lib_meta(jlib, "rsqrt"),
        EPS).astype(jnp.float32))
    ms_t, ms_j = _ms_both(np.asarray(xt.float()))
    same = ms_t == ms_j
    assert same[:3].all()
    out_bits = lib.meta("rsqrt").out_bits
    table_tol = 2 * 2.0 ** -(out_bits - 1)
    bf16 = 2.0 ** -7 if dtype == "bfloat16" else 0.0  # one output rounding
    np.testing.assert_allclose(got[same], want[same], rtol=1e-6 + bf16)
    np.testing.assert_allclose(got, want, rtol=table_tol + bf16, atol=1e-30)


def test_plain_matches_reference_interpret_kernel(libs):
    lib, jlib = libs
    x, gamma = _inputs(seed=1)
    got = approx_rmsnorm_library(torch.from_numpy(x), torch.from_numpy(gamma),
                                 lib, EPS).numpy()
    kern = np.asarray(fused_rmsnorm_lib(
        jnp.asarray(x), jnp.asarray(gamma), jlib.coeffs.reshape(-1, 3),
        jax_lib_meta(jlib, "rsqrt"), r_max=jlib.coeffs.shape[1], eps=EPS,
        interpret=True))
    ms_t, ms_j = _ms_both(x)
    same = ms_t == ms_j
    out_bits = lib.meta("rsqrt").out_bits
    np.testing.assert_allclose(got[same], kern[same], rtol=1e-6)
    np.testing.assert_allclose(got, kern, rtol=2 * 2.0 ** -(out_bits - 1))


def test_rsqrt_codes_cover_both_segments(libs):
    """Even exponents address [1, 2), odd ones [2, 4); the code times the
    exponent half reconstructs ms to the table's resolution."""
    lib, _ = libs
    meta = lib_meta(lib, "rsqrt")
    ms = torch.tensor([1.0, 2.0, 3.999, 0.25, 0.5, 1e-6, 7e5],
                      dtype=torch.float32)
    codes, h = rsqrt_codes(ms, meta)
    half = 1 << (meta["in_bits"] - 1)
    seg = (codes >= half).to(torch.float32)
    v = (1.0 + (codes - seg * half).to(torch.float32) / half) * 2.0 ** seg
    recon = v * 4.0 ** h.to(torch.float32)
    np.testing.assert_allclose(recon.numpy(), ms.numpy(), rtol=2.0 / half)


def test_leading_shape_and_dtype_preserved(libs):
    lib, _ = libs
    x = torch.randn(2, 3, 64, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0))
    out = approx_rmsnorm_library(x, torch.ones(64), lib)
    assert out.shape == x.shape and out.dtype == torch.bfloat16


def test_unfused_interp_rmsnorm_matches_reference(libs):
    """The frexp-based rsqrt glue of the unfused interp backend against the
    reference's: equal codes where mean(x^2) agrees bitwise (rtol 1e-6 for
    the reference's inexact CPU exp2), 2 table ulps elsewhere."""
    from repro.numerics.ops import InterpNumerics as JaxInterp
    from repro_torch.numerics.ops import InterpNumerics

    lib, jlib = libs
    x, gamma = _inputs(seed=2)
    got = InterpNumerics(lib).rmsnorm(torch.from_numpy(x),
                                      torch.from_numpy(gamma)).numpy()
    want = np.asarray(JaxInterp(jlib).rmsnorm(jnp.asarray(x),
                                              jnp.asarray(gamma)))
    ms_t, ms_j = _ms_both(x)
    same = ms_t == ms_j
    out_bits = lib.meta("rsqrt").out_bits
    np.testing.assert_allclose(got[same], want[same], rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -(out_bits - 1))
