"""Designs whose coefficients exceed int32 (the "wide" path) on the port,
against the reference (twins of ``tests/kernels/test_wide_eval.py``).

The port evaluates them in native int64 (``interp_eval_wide``); the
reference emulates int64 with 32-bit word pairs (``_umul32``, ``_add64``,
``_shra64``), helpers the port has no use for. The twin of the reference's
word-level property test therefore holds ``interp_eval_wide`` against the
reference's two-word ``interp_eval_wide`` on random wide designs: every
code, bitwise.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.table import TableDesign as JaxTableDesign
from repro.kernels.interp.ops import table_eval as jax_table_eval
from repro.kernels.interp.ref import interp_eval_wide as jax_interp_eval_wide
from repro.numerics.ops import table_eval_int as jax_table_eval_int
from repro_torch.core.table import CoeffMeta, TableDesign
from repro_torch.kernels.interp.ops import table_eval
from repro_torch.kernels.interp.ref import interp_eval_wide
from repro_torch.numerics.ops import table_eval_int


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wide_recip_design(in_bits: int = 12, R: int = 4) -> TableDesign:
    """The reference test's wide-output reciprocal: linear fits of
    V = 2^(2b+1) / (2^b + Z) per region (b = 17), whose c column (~36
    bits) and scaled b column exceed int32."""
    b_out, k, n, w = 17, 18, 1 << R, in_bits - R
    z0 = np.arange(n, dtype=np.float64) * (1 << w)
    z1 = z0 + (1 << w)
    f0 = 2.0 ** (2 * b_out + 1) / (2.0 ** b_out + z0)
    f1 = 2.0 ** (2 * b_out + 1) / (2.0 ** b_out + z1)
    slope = np.round((f1 - f0) / (1 << w) * (1 << k)).astype(np.int64)
    c = np.round(f0 * (1 << k)).astype(np.int64)
    assert np.abs(c).max() >= 2**31, "premise: c exceeds int32"
    return TableDesign(
        name="recip_wide_test", in_bits=in_bits, out_bits=b_out + 1,
        lookup_bits=R, k=k, degree=1, sq_trunc=0, lin_trunc=0,
        a=np.zeros(n, np.int64), b=slope, c=c,
        a_meta=CoeffMeta(1, 0, False),
        b_meta=CoeffMeta(int(np.abs(slope).max()).bit_length(), 0, True),
        c_meta=CoeffMeta(int(c.max()).bit_length(), 0, False))


def _jax(d: TableDesign) -> JaxTableDesign:
    return JaxTableDesign.from_dict(d.to_dict())


def _dp(d):
    return dict(eval_bits=d.eval_bits, k=d.k, sq_trunc=d.sq_trunc,
                lin_trunc=d.lin_trunc, degree=d.degree)


def test_wide_recip_exact_vs_numpy_oracle():
    """``table_eval`` and the numerics layer's ``table_eval_int`` route an
    oversized design to the int64 path: equal to the exhaustive int64
    oracle and to the reference's. The int32 operand the pre-fix reference
    wrapped silently is refused outright."""
    d = _wide_recip_design()
    assert not d.fits_int32
    codes = np.arange(1 << d.in_bits, dtype=np.int64)
    ref = d.eval_int(codes)
    assert np.abs(ref).max() < 2**31
    ct, jc = torch.from_numpy(codes.astype(np.int32)), jnp.asarray(
        codes, jnp.int32)
    got = table_eval(ct, d).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        table_eval_int(ct, d).numpy().astype(np.int64), ref)
    for use_kernel in (False, True):
        np.testing.assert_array_equal(got, np.asarray(jax_table_eval(
            jc, _jax(d), use_kernel=use_kernel)).astype(np.int64))
    np.testing.assert_array_equal(
        got, np.asarray(jax_table_eval_int(jc, _jax(d))).astype(np.int64))
    with pytest.raises(ValueError, match="exceed int32"):
        d.device_coeffs("cpu")


def test_wide_quadratic_and_large_k():
    """A quadratic wide design (a * sq^2 past 32 bits) and shifts k >= 32."""
    rng = np.random.default_rng(0)
    in_bits, R = 12, 4
    n = 1 << R
    a = rng.integers(-(1 << 21), 1 << 21, n).astype(np.int64)
    b = -rng.integers(1 << 32, 1 << 33, n).astype(np.int64)
    c = rng.integers(1 << 36, 1 << 37, n).astype(np.int64)
    codes = np.arange(1 << in_bits, dtype=np.int64)
    for k, degree in [(14, 2), (33, 1), (32, 2)]:
        d = TableDesign(
            name=f"wide_k{k}", in_bits=in_bits, out_bits=8, lookup_bits=R,
            k=k, degree=degree, sq_trunc=1, lin_trunc=0,
            a=a if degree == 2 else np.zeros(n, np.int64), b=b, c=c,
            a_meta=CoeffMeta(22, 0, True), b_meta=CoeffMeta(33, 0, True),
            c_meta=CoeffMeta(37, 0, False))
        got = table_eval(torch.from_numpy(codes.astype(np.int32)),
                         d).numpy().astype(np.int64)
        np.testing.assert_array_equal(got, d.eval_int(codes),
                                      err_msg=f"k={k}")
        np.testing.assert_array_equal(got, np.asarray(jax_table_eval(
            jnp.asarray(codes, jnp.int32), _jax(d), use_kernel=False)
        ).astype(np.int64), err_msg=f"k={k}")


def test_wide_eval_standalone():
    """``interp_eval_wide`` called directly on the int64 operand (the
    reference's jitted call): equal to the oracle and the reference."""
    d = _wide_recip_design()
    codes = np.arange(1 << d.in_bits, dtype=np.int32)
    got = interp_eval_wide(torch.from_numpy(codes),
                           d.device_coeffs_wide("cpu"), **_dp(d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  d.eval_int(codes.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_interp_eval_wide(jnp.asarray(codes), _jax(d).device_coeffs_wide(),
                             **_dp(d))))


def test_wide_eval_bitwise_reference_word_pairs():
    """Twin of the word-level property test: random wide designs (degree 1
    and 2, coefficients to 47 bits, shifts 0-40, truncations) on every
    code, the port's int64 against the reference's word pairs and the
    int64 oracle, including the low-32-bit wrap of outputs past int32."""
    rng = np.random.default_rng(1)
    codes = np.arange(1 << 12, dtype=np.int32)
    for i in range(12):
        degree, r = int(rng.integers(1, 3)), int(rng.integers(2, 7))
        n = 1 << r
        a = (rng.integers(-2**20, 2**20, n) if degree == 2
             else np.zeros(n, np.int64))
        b = rng.integers(-2**40, 2**40, n)
        c = rng.integers(-2**46, 2**46, n)
        meta = CoeffMeta(48, 0, True)
        d = TableDesign(f"wide{i}", 12, 20, r, int(rng.integers(0, 41)),
                        degree, int(rng.integers(0, 3)),
                        int(rng.integers(0, 3)), a, b, c, meta, meta, meta)
        assert not d.fits_int32
        got = interp_eval_wide(torch.from_numpy(codes),
                               d.device_coeffs_wide("cpu"), **_dp(d)).numpy()
        want = np.asarray(jax_interp_eval_wide(
            jnp.asarray(codes), _jax(d).device_coeffs_wide(), **_dp(d)))
        np.testing.assert_array_equal(got, want, err_msg=d.name)
        oracle = d.eval_int(codes.astype(np.int64))
        np.testing.assert_array_equal(
            got.astype(np.int64), (oracle + 2**31) % 2**32 - 2**31,
            err_msg=d.name)
