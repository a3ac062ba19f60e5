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

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.kernels.rmsnorm.kernel import fused_rmsnorm_lib
from repro.kernels.rmsnorm.ref import fused_rmsnorm_lib_ref
from repro.kernels.softmax.ops import lib_meta as jax_lib_meta
from repro_torch.api import spec_for
from repro_torch.api.library import (DEFAULT_LIBRARY_KINDS, DEFAULT_TABLE_KEY,
                                     TABLES_DIR, InterpLibrary)
from repro_torch.core.table import TableDesign
from repro_torch.kernels.interp.ops import lib_meta
from repro_torch.kernels.rmsnorm.kernel import (launch_shape,
                                                rmsnorm_lib_cuda,
                                                rmsnorm_tab_cuda, vector_ok)
from repro_torch.kernels.rmsnorm.ops import (approx_rmsnorm_fused,
                                             approx_rmsnorm_library)
from repro_torch.kernels.rmsnorm.ref import rsqrt_codes
from repro_torch.numerics.ops import (ExactNumerics, FusedInterpNumerics,
                                      InterpNumerics, PlainFusedNumerics,
                                      approx_rmsnorm)
from repro_torch.segment import explore_segmented


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


def _vendored(kind):
    return TableDesign.from_dict(json.loads(
        (TABLES_DIR / f"{kind}_{DEFAULT_TABLE_KEY}.json").read_text()))


@pytest.fixture(scope="module")
def seg_lib():
    """The default library with its rsqrt slot segmented (ROM v2), the
    other slots uniform."""
    designs = [explore_segmented(spec_for(k), max_depth=6, engine="batched",
                                 device="cpu") if k == "rsqrt"
               else _vendored(k) for k in DEFAULT_LIBRARY_KINDS]
    lib = InterpLibrary.from_designs(designs, DEFAULT_LIBRARY_KINDS,
                                     device="cpu")
    assert lib.segmented_kinds == ("rsqrt",)
    return lib


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


# -- the norm scale as stored: float32 or bfloat16 --------------------------

_PATHS = {
    "library": lambda lib, seg: functools.partial(
        approx_rmsnorm_library, library=lib),
    "library_segmented": lambda lib, seg: functools.partial(
        approx_rmsnorm_library, library=seg),
    "fused_per_table": lambda lib, seg: functools.partial(
        approx_rmsnorm_fused, design=_vendored("rsqrt")),
    "fused_numerics_segmented": lambda lib, seg: FusedInterpNumerics(
        seg).rmsnorm,
    "plain_fused_numerics": lambda lib, seg: PlainFusedNumerics(lib).rmsnorm,
    "interp": lambda lib, seg: InterpNumerics(lib).rmsnorm,
    "interp_segmented": lambda lib, seg: InterpNumerics(seg).rmsnorm,
    "exact": lambda lib, seg: ExactNumerics.rmsnorm,
    "approx_rmsnorm": lambda lib, seg: functools.partial(
        approx_rmsnorm, design=_vendored("rsqrt")),
}


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", list(_PATHS))
def test_bf16_gamma_equals_its_f32_cast_bitwise(path, xdtype, libs,
                                                seg_lib):
    """A bf16 norm scale as stored gives bitwise the output of its float32
    cast on every rmsnorm path (bf16 -> f32 is exact and each path
    promotes gamma to float32), on the uniform and segmented libraries."""
    fn = _PATHS[path](libs[0], seg_lib)
    x, gamma = _inputs(seed=3, rows=6, d=192)
    xt = torch.from_numpy(x).to(getattr(torch, xdtype))
    g16 = torch.from_numpy(gamma).to(torch.bfloat16)
    got = fn(xt, g16)
    assert got.dtype == xt.dtype
    assert torch.equal(got, fn(xt, g16.to(torch.float32)))


@pytest.mark.parametrize("entry", ["rmsnorm_lib", "rmsnorm_tab"])
@pytest.mark.parametrize("bad,err", [("float16", TypeError),
                                     ("float64", TypeError),
                                     ("short", ValueError),
                                     ("matrix", ValueError)])
def test_wrapper_refuses_gamma(entry, bad, err, libs):
    """The CUDA wrappers take gamma in float32 or bfloat16 of shape (D,)
    and cast nothing: another dtype or shape raises before any launch."""
    x = torch.zeros(4, 64)
    gamma = {"float16": torch.ones(64, dtype=torch.float16),
             "float64": torch.ones(64, dtype=torch.float64),
             "short": torch.ones(63),
             "matrix": torch.ones(1, 64)}[bad]
    with pytest.raises(err, match="gamma"):
        if entry == "rmsnorm_lib":
            rmsnorm_lib_cuda(x, gamma, libs[0])
        else:
            rmsnorm_tab_cuda(x, gamma, _vendored("rsqrt"))


@pytest.mark.parametrize("rows,d,itemsize,vector,want", [
    (4, 4096, 2, True, (1, 256, 2, 1)),     # Yi-6B decode
    (512, 4096, 2, True, (1, 256, 2, 1)),   # Yi-6B prefill
    (4, 2048, 2, True, (1, 256, 1, 1)),     # DeepSeekMoE decode
    (511, 2048, 2, True, (1, 256, 1, 1)),   # DeepSeekMoE prefill
    (4, 4096, 4, True, (1, 256, 4, 1)),     # float32: 1024 vectors
    (3, 4095, 2, False, (0, 512, 8, 1)),    # masked: 4095 elements
    (7, 1000, 4, False, (0, 256, 4, 1)),
    (5, 64, 4, True, (1, 32, 1, 4)),        # narrow rows share a block
    (2, 1 << 20, 2, True, (1, 512, 8, 1)),  # passes of 4096 vectors
])
def test_launch_shape(rows, d, itemsize, vector, want):
    """Threads per row from D: one chunk a thread up to 256 threads, then
    up to 8 chunks, then up to 512 threads (longer rows take passes); 128
    threads or more a block."""
    assert launch_shape(rows, d, itemsize, vector) == want


def test_launch_shape_refuses_bad_thread_counts():
    for tpr in (0, 48, 2048):
        with pytest.raises(ValueError, match="threads per row"):
            launch_shape(4, 4096, 2, True, tpr)
    with pytest.raises(ValueError, match="at most 512"):
        launch_shape(4, 1 << 16, 2, True, 1024)  # 8 vectors a thread
    assert launch_shape(4, 4096, 2, True, 128) == (1, 128, 4, 1)


def test_vector_body_needs_whole_vectors_and_aligned_rows():
    """The vector body takes D a multiple of 8 bf16 (4 f32) and 16-byte
    aligned operands; a row view at an odd offset, or D = 4095, takes the
    masked body."""
    g = torch.ones(4096, dtype=torch.bfloat16)
    x = torch.zeros(3, 4096, dtype=torch.bfloat16)
    assert vector_ok(x, g, torch.empty_like(x))
    flat = torch.zeros(3 * 4096 + 1, dtype=torch.bfloat16)
    view = flat[1:].view(3, 4096)  # contiguous rows at a 2-byte offset
    assert not vector_ok(view, g, torch.empty_like(view))
    odd = torch.zeros(3, 4095, dtype=torch.bfloat16)
    assert not vector_ok(odd, g[:4095], torch.empty_like(odd))
    f = torch.zeros(7, 1000)
    assert vector_ok(f, torch.ones(1000), torch.empty_like(f))
