"""Library-bound attention: the port's plain version against the
reference's (``attention_fused_library(use_kernel=False)``), the reference
kernel in interpret mode, and the chunked glue path of ``attention_core``.

Tolerances are stated from ``softmax_ulp_bound`` (the certified relative
error of one table-softmax term, exp and recip tables together):
* two unchunked versions differ only where float reassociation moves a
  score, a row sum or the reference's inexact CPU exp2 across a table-code
  boundary, each at most one table ulp: |diff| <= bound * max|v|;
* a chunked version also multiplies each weight by its chain of running
  corrections, each itself a table read: |diff| <= (n_chunks + 2) * bound *
  max|v|.
Rows with no live key (padded query rows) are excluded: the reference's CPU
exp2 flushes 2^-126 to zero where the port keeps the exact power.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.kernels.flashattn.ops import \
    attention_fused_library as jax_attention
from repro.models.attention import attention_core as jax_attention_core
from repro.numerics.ops import ExactNumerics as JaxExact
from repro.numerics.ops import InterpNumerics as JaxInterp
from repro_torch.api.library import InterpLibrary
from repro_torch.kernels.flashattn.ops import attention_fused_library
from repro_torch.models.attention import attention_core
from repro_torch.numerics.ops import (ExactNumerics, FusedInterpNumerics,
                                      InterpNumerics, softmax_ulp_bound)


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


def _bound(lib):
    return softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))


def _qkv(seed, b, sq, sk, h, kvh, d, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, dv or d)).astype(np.float32)
    return q, k, v


def _both(libs, q, k, v, q_pos, kv_pos, **kw):
    lib, jlib = libs
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)]
    got = attention_fused_library(*t[:3], lib, q_pos=t[3], kv_pos=t[4],
                                  **kw).numpy()
    ref = jax.jit(functools.partial(jax_attention, use_kernel=False, **kw))
    want = np.asarray(ref(*(jnp.asarray(a) for a in (q, k, v)), jlib,
                          q_pos=jnp.asarray(q_pos),
                          kv_pos=jnp.asarray(kv_pos)))
    return got, want


def _arange(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


CASES = {
    # GQA g = 2, causal prefill
    "gqa_prefill": dict(b=2, sq=24, sk=24, h=4, kvh=2, d=16, window=None),
    # one query per slot against a cache with dead (-1) slots
    "decode_dead_slots": dict(b=3, sq=1, sk=40, h=4, kvh=2, d=16,
                              window=None),
    # sliding window over a causal prefill
    "window": dict(b=1, sq=32, sk=32, h=4, kvh=1, d=8, window=7),
    # Dk != Dv
    "dk_ne_dv": dict(b=1, sq=9, sk=9, h=2, kvh=2, d=16, dv=8, window=None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_oracle(case, libs):
    c = dict(CASES[case])
    window = c.pop("window")
    b, sq, sk = c["b"], c["sq"], c["sk"]
    q, k, v = _qkv(sorted(CASES).index(case), **c)
    if case == "decode_dead_slots":
        q_pos = np.array([[20], [35], [7]], np.int32)
        kv_pos = _arange(b, sk)
        kv_pos[0, 21:] = -1
        kv_pos[1, ::3] = -1  # holes
        kv_pos[2, 8:] = -1
    else:
        q_pos, kv_pos = _arange(b, sq), _arange(b, sk)
    got, want = _both(libs, q, k, v, q_pos, kv_pos, causal=True,
                      window=window)
    assert got.shape == (b, sq, c["h"], c.get("dv") or c["d"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_bound(libs[0]) * np.abs(v).max())


def test_padded_query_rows(libs):
    q, k, v = _qkv(5, 2, 12, 12, 4, 2, 16)
    q_pos, kv_pos = _arange(2, 12), _arange(2, 12)
    q_pos[1, 9:] = -1  # right-padded query rows of request 1
    kv_pos[1, 9:] = -1
    got, want = _both(libs, q, k, v, q_pos, kv_pos, causal=True)
    live = q_pos >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=_bound(libs[0]) * np.abs(v).max())
    assert np.isfinite(got).all()


def test_plain_matches_reference_interpret_kernel(libs):
    """The reference's chunked kernel in interpret mode on a tiny GQA case
    (block_k = 8 over Sk = 16: two chunks)."""
    lib, jlib = libs
    q, k, v = _qkv(11, 1, 16, 16, 2, 1, 8)
    pos = _arange(1, 16)
    got = attention_fused_library(*(torch.from_numpy(a) for a in (q, k, v)),
                                  lib, q_pos=torch.from_numpy(pos),
                                  kv_pos=torch.from_numpy(pos)).numpy()
    kern = np.asarray(jax_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jlib, q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), use_kernel=True, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=0,
                               atol=(2 + 2) * _bound(lib) * np.abs(v).max())


@pytest.mark.parametrize("backend", ["exact", "interp"])
def test_chunked_glue_path_matches_reference(backend, libs):
    """attention_core's chunked online-softmax glue (16 kv chunks, so the
    liveness skip runs) through unfused numerics, port vs reference."""
    lib, jlib = libs
    q, k, v = _qkv(3, 2, 16, 64, 4, 2, 8)
    q_pos = _arange(2, 16, start=48)
    kv_pos = _arange(2, 64)
    kv_pos[1, 40:] = -1
    if backend == "exact":
        tn, jn, atol = ExactNumerics(), JaxExact(), 1e-5
    else:
        tn, jn = InterpNumerics(lib), JaxInterp(jlib)
        atol = (16 + 2) * _bound(lib) * np.abs(v).max()
    got = attention_core(*(torch.from_numpy(a) for a in (q, k, v)),
                         torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                         tn, q_chunk=8, kv_chunk=4).numpy()
    want = np.asarray(jax_attention_core(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), jn, q_chunk=8, kv_chunk=4))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_fused_hook_routing(libs):
    """The reference's routing: Sk > 4096 always takes the glue path, and
    Sq * Sk > 2^22 does so where the plain version would form the whole
    score block (the CPU)."""
    lib, _ = libs
    num = FusedInterpNumerics(lib)
    q = torch.zeros(1, 1, 2, 8)
    long_k = torch.zeros(1, 4097, 1, 8)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    assert num.fused_attention(q, long_k, long_k, pos, pos, causal=True,
                               window=None, scale=None) is None
    big_q = torch.zeros(1, 2048, 2, 8)
    k = torch.zeros(1, 4096, 1, 8)
    assert num.fused_attention(big_q, k, k, pos, pos, causal=True,
                               window=None, scale=None) is None
    assert num.fused_attention(q, k[:, :8], k[:, :8], pos,
                               torch.zeros(1, 8, dtype=torch.int32),
                               causal=True, window=None,
                               scale=None).shape == (1, 1, 2, 8)


@pytest.mark.parametrize("window", [None, 5])
def test_chunked_twin_matches_reference_interpret_kernel(window, libs):
    """The tile-by-tile twin against the reference kernel with the same key
    tiles (block_k = 8): only float reassociation separates them, so the
    mean error is at float level and the max within one table-ulp flip
    (bound * max|v|)."""
    from repro.kernels.flashattn.kernel import flash_attention_lib
    from repro.kernels.softmax.ops import lib_meta as jax_lib_meta
    from repro_torch.kernels.flashattn.ref import \
        flash_attention_lib_chunked_ref
    from repro_torch.kernels.interp.ops import lib_meta

    lib, jlib = libs
    rng = np.random.default_rng(21)
    g, sq, sk, d = 2, 16, 32, 8
    q = rng.standard_normal((2 * g, sq, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, d)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(16, 32, dtype=np.int32), (2 * g, sq))
    kv_pos = _arange(2, sk)
    kv_pos[1, 24:] = -1
    kern = np.asarray(flash_attention_lib(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)),
        jlib.coeffs.reshape(-1, 3), jax_lib_meta(jlib, "exp2neg"),
        jax_lib_meta(jlib, "recip"), r_max=jlib.coeffs.shape[1],
        window=window, kv_group=g, block_q=8, block_k=8, interpret=True))
    t = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in
         dict(q=q, k=k, v=v, qp=q_pos, kp=kv_pos).items()}
    got = flash_attention_lib_chunked_ref(
        t["q"], t["k"].repeat_interleave(g, 0), t["v"].repeat_interleave(g, 0),
        t["qp"], t["kp"].repeat_interleave(g, 0), lib.coeffs,
        lib_meta(lib, "exp2neg"), lib_meta(lib, "recip"), window=window,
        block_k=8).numpy()
    err = np.abs(got - kern)
    assert err.max() <= _bound(lib) * np.abs(v).max()
    assert err.mean() <= 1e-5
