"""The library-bound fused softmax: the port's plain version against the
reference's ``fused_softmax_lib`` in interpret mode and its jnp oracle
``fused_softmax_lib_ref``, and every numerics backend's ``softmax`` against
the reference's.

Tolerances:
* exp2neg table codes: bit-exact (they come from the row max and one
  element, computed in the same float32 order in both packages).
* outputs: relative ``softmax_ulp_bound`` of the two tables. Where the
  codes agree the terms e differ only by the reference's float32 ``exp2``
  of an integer (a few f32 ulps on the CPU, and 2^-126 flushed to 0; the
  port takes exact powers of two), and the row sum's order may move the
  reciprocal's code by one step, both far inside the bound; bf16 outputs
  add one output rounding (2^-7 relative). An absolute 1e-30 covers the
  flushed 2^-126 terms.
* the exact backend: torch.softmax against jax.nn.softmax, rtol 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.kernels.softmax.kernel import fused_softmax_lib
from repro.kernels.softmax.ops import lib_meta as jax_lib_meta
from repro.kernels.softmax.ref import fused_softmax_lib_ref as jax_ref
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro_torch.api.library import InterpLibrary
from repro_torch.kernels.softmax.ops import approx_softmax_library, lib_meta
from repro_torch.kernels.softmax.ref import (fused_softmax_lib_ref,
                                             softmax_exp)
from repro_torch.numerics.ops import (PlainFusedNumerics, get_numerics,
                                      softmax_ulp_bound)

LOG2E = 1.4426950408889634


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


def _inputs(shape, seed=0):
    """Router-like logits; row 0 is constant (every term ties) and row 1
    spreads past the t = 126 clamp of the exp table."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 8.0, shape[:-1] + (1,))
         ).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.75
    flat[1, ::3] = -200.0
    return x


def _jax_exp_codes(x, eb):
    """The exp2neg codes of the reference's ``_softmax_body`` (its first
    lines, in jnp on the same float32 inputs)."""
    xf = jnp.asarray(x, jnp.float32)
    m = jnp.max(xf, axis=-1, keepdims=True)
    t = jnp.minimum((m - xf) * LOG2E, 126.0)
    frac = t - jnp.floor(t)
    return np.asarray(jnp.clip(jnp.round(frac * (1 << eb)).astype(jnp.int32),
                               0, (1 << eb) - 1))


def _tol(lib, dtype):
    bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    return bound + (2.0 ** -7 if dtype == "bfloat16" else 0.0)


def _assert_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= rel * np.abs(want) + 1e-30), \
        float(np.max(np.abs(got - want) / (np.abs(want) + 1e-30)))


def _both(x, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return xt, xj


@pytest.mark.parametrize("shape", [(16, 128), (8, 256)])
def test_plain_twin_matches_reference_kernel_interpret(shape, libs):
    lib, jlib = libs
    x = _inputs(shape, seed=shape[1])
    em, rm = jax_lib_meta(jlib, "exp2neg"), jax_lib_meta(jlib, "recip")
    want = fused_softmax_lib(jnp.asarray(x), jlib.coeffs.reshape(-1, 3), em,
                             rm, r_max=jlib.coeffs.shape[1], interpret=True)
    got = approx_softmax_library(torch.from_numpy(x), lib)
    _assert_close(got.numpy(), want, _tol(lib, "float32"))
    codes, _ = softmax_exp(torch.from_numpy(x), lib.coeffs,
                           lib_meta(lib, "exp2neg"))
    np.testing.assert_array_equal(codes.numpy(),
                                  _jax_exp_codes(x, em["in_bits"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 64), (4, 1, 64)])
def test_plain_twin_matches_reference_oracle(shape, dtype, libs):
    lib, jlib = libs
    xt, xj = _both(_inputs(shape, seed=len(shape)), dtype)
    em, rm = jax_lib_meta(jlib, "exp2neg"), jax_lib_meta(jlib, "recip")
    want = jax_ref(xj.reshape(-1, shape[-1]), jlib.coeffs, em, rm
                   ).reshape(shape)
    got = fused_softmax_lib_ref(xt, lib.coeffs, lib_meta(lib, "exp2neg"),
                                lib_meta(lib, "recip"))
    assert got.dtype == xt.dtype and tuple(got.shape) == shape
    _assert_close(got.float().numpy(), want.astype(jnp.float32),
                  _tol(lib, dtype))
    codes, e = softmax_exp(xt, lib.coeffs, lib_meta(lib, "exp2neg"))
    np.testing.assert_array_equal(codes.numpy(), _jax_exp_codes(
        np.asarray(xj.astype(jnp.float32)), em["in_bits"]))
    # a constant row: every term is tab(0) * 2^-out_bits, all equal
    e0 = e.reshape(-1, shape[-1])[0]
    assert torch.equal(e0, torch.full_like(e0, float(e0[0])))
    # the clamp: t = 126 gives the smallest normal power of two scale
    assert float(e.reshape(-1, shape[-1])[1, 0]) <= 2.0 ** -125


def test_segmented_slot_raises(libs):
    """A segmented slot decodes through the segment-index datapath; a
    segment spec that does not fit its slot (more leaf and table rows than
    the ROM's r_max, or a leaf count its rows do not match) raises."""
    lib, _ = libs
    em = lib_meta(lib, "exp2neg")
    em["eval"]["seg"] = (12, 8, 3, ((4, 0, 0, 0, 1),) * 3)
    with pytest.raises(ValueError, match="does not fit"):
        fused_softmax_lib_ref(torch.zeros(2, 8), lib.coeffs, em,
                              lib_meta(lib, "recip"))
    em["eval"]["seg"] = (12, 2, 3, ((10, 0, 0, 0, 1),) * 2)
    with pytest.raises(ValueError, match="does not fit"):
        fused_softmax_lib_ref(torch.zeros(2, 8), lib.coeffs, em,
                              lib_meta(lib, "recip"))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("name", ["exact", "interp", "interp-fused",
                                  "plain-fused"])
def test_backend_softmax_matches_reference(name, axis, libs):
    """Each backend against the reference's on the same (6, 9, 64) logits;
    ``axis=0`` sends the fused backends to the glue path, as the
    reference's does."""
    lib, jlib = libs
    x = _inputs((6, 9, 64), seed=5)
    if name == "plain-fused":
        num, jname = PlainFusedNumerics(lib), "interp-fused"
    else:
        num = get_numerics(name, None if name == "exact" else lib)
        jname = name
    jnum = jax_get_numerics(jname, None if jname == "exact" else jlib)
    want = np.asarray(jax.jit(lambda v: jnum.softmax(v, axis=axis))(
        jnp.asarray(x)))
    got = num.softmax(torch.from_numpy(x), axis=axis).numpy()
    assert got.dtype == np.float32
    if name == "exact":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    else:
        _assert_close(got, want, _tol(lib, "float32"))
