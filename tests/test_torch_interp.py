"""The Figure-1 datapath: the port's plain ``library_eval``,
``InterpLibrary.eval_int`` and ``table_eval`` (int32 and int64 wide paths)
are bit-exact against the reference's integer oracles over every input code
of every default kind."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DEFAULT_LIBRARY_KINDS, default_explorer
from repro.core.table import TableDesign as JaxTableDesign
from repro.kernels.interp.kernel import interp_eval_2d, library_eval_2d
from repro.kernels.interp.ops import table_eval as jax_table_eval
from repro.kernels.interp.ref import library_eval_ref as jax_library_eval_ref
from repro_torch.api.library import DEFAULT_TABLE_KEY, TABLES_DIR, InterpLibrary
from repro_torch.core.table import CoeffMeta, TableDesign
from repro_torch.kernels.interp.ops import library_eval, table_eval
from repro_torch.kernels.interp.ref import interp_eval_ref, library_eval_ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    return InterpLibrary.default_library("cpu"), default_explorer().compile()


@pytest.mark.parametrize("kind", DEFAULT_LIBRARY_KINDS)
def test_all_codes_bit_exact(kind, libs):
    lib, jlib = libs
    codes = np.arange(1 << lib.meta(kind).in_bits, dtype=np.int32)
    fid = lib.func_id(kind)
    want = default_explorer().get_table(kind).eval_int(codes)
    via_eval_int = lib.eval_int(torch.from_numpy(codes), kind).numpy()
    via_library = library_eval(torch.from_numpy(codes), fid, lib.coeffs,
                               lib.meta_rows()).numpy()
    jax_ref = np.asarray(jax_library_eval_ref(
        jnp.asarray(codes), jnp.full(codes.shape, fid, jnp.int32),
        jlib.coeffs, jlib.meta_rows()))
    for got in (via_eval_int, via_library, jax_ref):
        np.testing.assert_array_equal(got, want)
    assert via_eval_int.dtype == np.int32


def test_mixed_fids_tile_matches_reference_interpret_kernel(libs):
    """One (8, 128) tile of random codes and per-element function ids:
    port plain == reference Pallas kernel in interpret mode == reference
    gather oracle, bitwise."""
    lib, jlib = libs
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4096, (8, 128)).astype(np.int32)
    fids = rng.integers(0, len(lib), (8, 128)).astype(np.int32)
    got = library_eval(torch.from_numpy(codes), torch.from_numpy(fids),
                       lib.coeffs, lib.meta_rows()).numpy()
    kern = np.asarray(library_eval_2d(jnp.asarray(codes), jnp.asarray(fids),
                                      jlib.coeffs, jlib.meta_rows(),
                                      interpret=True))
    ref = np.asarray(jax_library_eval_ref(jnp.asarray(codes),
                                          jnp.asarray(fids), jlib.coeffs,
                                          jlib.meta_rows()))
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, ref)


def test_int32_semantics_outside_the_code_range(libs):
    """Negative and oversized codes exercise the logical region shift, the
    clamped gather and the wrapped int32 Horner step: still bitwise equal
    to the reference oracle."""
    lib, jlib = libs
    rng = np.random.default_rng(1)
    codes = np.concatenate([
        rng.integers(-2**31, 2**31 - 1, 512, dtype=np.int64),
        np.array([-1, -4096, 4096, 65535, 2**31 - 1, -2**31])]).astype(np.int32)
    fids = rng.integers(0, len(lib), codes.shape).astype(np.int32)
    got = library_eval_ref(torch.from_numpy(codes), torch.from_numpy(fids),
                           lib.coeffs, lib.meta_rows()).numpy()
    ref = np.asarray(jax_library_eval_ref(jnp.asarray(codes),
                                          jnp.asarray(fids), jlib.coeffs,
                                          jlib.meta_rows()))
    np.testing.assert_array_equal(got, ref)


def test_broadcast_fid_equals_elementwise_fids(libs):
    lib, _ = libs
    codes = torch.arange(4096, dtype=torch.int32).reshape(4, 1, 1024)
    fid = lib.func_id("silu")
    a = library_eval(codes, fid, lib.coeffs, lib.meta_rows())
    b = library_eval(codes, torch.full_like(codes, fid), lib.coeffs,
                     lib.meta_rows())
    assert a.shape == codes.shape and torch.equal(a, b)


def _vendored(kind: str) -> TableDesign:
    import json

    return TableDesign.from_dict(json.loads(
        (TABLES_DIR / f"{kind}_{DEFAULT_TABLE_KEY}.json").read_text()))


@pytest.mark.parametrize("kind", DEFAULT_LIBRARY_KINDS)
def test_table_eval_int32_path_all_codes(kind):
    """``table_eval`` of one 12-bit design (the int32 path: the
    ``interp_eval`` kernel's plain version on the CPU) == eval_int == the
    reference's ``table_eval`` through its interpret-mode kernel."""
    d = _vendored(kind)
    assert d.fits_int32
    codes = np.arange(1 << d.in_bits, dtype=np.int32)
    got = table_eval(torch.from_numpy(codes), d)
    assert got.dtype == torch.int32
    want = d.eval_int(codes)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    jd = JaxTableDesign.from_dict(d.to_dict())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_table_eval(jnp.asarray(codes), jd,
                                               interpret=True)))


def test_interp_eval_ref_matches_reference_interpret_kernel():
    """One (8, 128) tile of random codes: the plain ``interp_eval`` ==
    the reference's ``interp_eval_2d`` in interpret mode, bitwise."""
    d = _vendored("recip")
    codes = np.random.default_rng(2).integers(0, 4096, (8, 128)
                                              ).astype(np.int32)
    dp = dict(eval_bits=d.eval_bits, k=d.k, sq_trunc=d.sq_trunc,
              lin_trunc=d.lin_trunc, degree=d.degree)
    got = interp_eval_ref(torch.from_numpy(codes),
                          torch.from_numpy(d.packed_coeffs()), **dp)
    want = interp_eval_2d(jnp.asarray(codes), jnp.asarray(d.packed_coeffs()),
                          interpret=True, **dp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _wide_design(degree: int) -> TableDesign:
    rng = np.random.default_rng(3 + degree)
    r = 4
    meta = CoeffMeta(47, 0, True)
    a = (rng.integers(-2**20, 2**20, 1 << r) if degree == 2
         else np.zeros(1 << r, np.int64))
    return TableDesign("wide", 12, 20, r, 30, degree, 1, 0, a,
                       rng.integers(-2**36, 2**36, 1 << r),
                       rng.integers(2**45, 2**46, 1 << r), meta, meta, meta)


@pytest.mark.parametrize("degree", [1, 2])
def test_table_eval_wide_path_all_codes(degree):
    """A design whose coefficients exceed int32 takes the int64 wide path:
    equal to eval_int and to the reference's two-word emulation."""
    d = _wide_design(degree)
    assert not d.fits_int32
    codes = np.arange(1 << d.in_bits, dtype=np.int32)
    got = table_eval(torch.from_numpy(codes), d).numpy()
    want = d.eval_int(codes)
    np.testing.assert_array_equal(got.astype(np.int64), want)
    jd = JaxTableDesign.from_dict(d.to_dict())
    np.testing.assert_array_equal(
        got, np.asarray(jax_table_eval(jnp.asarray(codes), jd)))
    assert d.device_coeffs_wide("cpu").dtype == torch.int64
    with pytest.raises(ValueError, match="exceed int32"):
        d.device_coeffs("cpu")


def _rows_design(r: int) -> TableDesign:
    """A synthetic 16-bit quadratic design of 2^r int32-fitting rows."""
    rng = np.random.default_rng(r)
    meta = CoeffMeta(24, 0, True)
    return TableDesign("rows", 16, 20, r, 4, 2, 0, 0,
                       rng.integers(-2**10, 2**10, 1 << r),
                       rng.integers(-2**16, 2**16, 1 << r),
                       rng.integers(-2**24, 2**24, 1 << r), meta, meta, meta)


@pytest.mark.parametrize("case", ["rows_past_shared_memory", "ragged"])
def test_interp_eval_ref_matches_reference_kernel_on_edge_shapes(case):
    """The plain ``interp_eval`` == the reference's ``interp_eval_2d`` in
    interpret mode: on a design of 2^15 rows (384 KB, past the 227 KB a
    block of the card can stage, so the kernel reads them in global
    memory), and on a ragged count of 1001 codes, zero-padded to the
    reference's (8, 128) tile and cut back."""
    d = _rows_design(15) if case == "rows_past_shared_memory" \
        else _vendored("recip")
    assert d.fits_int32
    n = 1024 if case == "rows_past_shared_memory" else 1001
    codes = np.random.default_rng(5).integers(
        0, 1 << d.in_bits, n).astype(np.int32)
    dp = dict(eval_bits=d.eval_bits, k=d.k, sq_trunc=d.sq_trunc,
              lin_trunc=d.lin_trunc, degree=d.degree)
    got = interp_eval_ref(torch.from_numpy(codes),
                          torch.from_numpy(d.packed_coeffs()), **dp)
    tile = np.zeros(8 * 128, np.int32)
    tile[:n] = codes
    want = interp_eval_2d(jnp.asarray(tile.reshape(8, 128)),
                          jnp.asarray(d.packed_coeffs()), interpret=True,
                          **dp)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(-1)[:n])
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  d.eval_int(codes))


_DP = dict(eval_bits=6, k=4, sq_trunc=0, lin_trunc=0, degree=2)


@pytest.mark.parametrize("case,exc", [
    ("codes_int64", TypeError), ("coeffs_float", TypeError),
    ("coeffs_four_columns", ValueError), ("coeffs_flat", ValueError),
    ("shift_32", ValueError), ("shift_negative", ValueError),
    ("two_devices", ValueError)])
def test_interp_eval_wrapper_refuses_before_any_build(case, exc,
                                                      monkeypatch):
    """``interp_eval_cuda`` checks its operands before it builds or loads
    the kernels: a wrong dtype, a coefficient shape other than (2^R, 3), a
    datapath shift outside [0, 32) and operands on two devices raise."""
    from repro_torch.kernels import build
    from repro_torch.kernels.interp.kernel import interp_eval_cuda

    def no_build():
        raise AssertionError("built before the operands were checked")

    monkeypatch.setattr(build, "load", no_build)
    codes = torch.zeros(16, dtype=torch.int32)
    coeffs = torch.zeros(64, 3, dtype=torch.int32)
    dp = dict(_DP)
    if case == "codes_int64":
        codes = codes.long()
    elif case == "coeffs_float":
        coeffs = coeffs.float()
    elif case == "coeffs_four_columns":
        coeffs = torch.zeros(64, 4, dtype=torch.int32)
    elif case == "coeffs_flat":
        coeffs = coeffs.reshape(-1)
    elif case == "shift_32":
        dp["eval_bits"] = 32
    elif case == "shift_negative":
        dp["k"] = -1
    else:
        coeffs = coeffs.to("meta")
    with pytest.raises(exc):
        interp_eval_cuda(codes, coeffs, **dp)


def test_interp_eval_wrapper_empty_call_launches_nothing(monkeypatch):
    """An empty call returns an empty int32 result of the codes' shape
    without building, launching or counting a launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels.interp.kernel import interp_eval_cuda

    monkeypatch.setattr(build, "load", lambda: pytest.fail("built"))
    n0 = build.LAUNCHES["interp_eval"]
    out = interp_eval_cuda(torch.zeros(0, 3, dtype=torch.int32),
                           torch.zeros(64, 3, dtype=torch.int32), **_DP)
    assert out.shape == (0, 3) and out.dtype == torch.int32
    assert build.LAUNCHES["interp_eval"] == n0
