"""The Figure-1 datapath: the port's plain ``library_eval`` and
``InterpLibrary.eval_int`` are bit-exact against the reference's integer
oracles over every input code of every default kind."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DEFAULT_LIBRARY_KINDS, default_explorer
from repro.kernels.interp.kernel import library_eval_2d
from repro.kernels.interp.ref import library_eval_ref as jax_library_eval_ref
from repro_torch.api.library import InterpLibrary
from repro_torch.kernels.interp.ops import library_eval
from repro_torch.kernels.interp.ref import library_eval_ref


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
