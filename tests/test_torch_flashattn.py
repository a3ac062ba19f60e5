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


# -- key splits (flash-decoding) ----------------------------------------------

SPLIT_SHAPES = [(4, 4, 1, 1024), (4, 16, 1, 1024), (4, 32, 1, 1024),
                (4, 4, 1, 4096), (1, 4, 64, 512), (1, 16, 8, 512),
                (1, 1, 1, 64), (2, 2, 1, 256), (1, 1, 1, 100000),
                (0, 4, 1, 100), (4, 4, 0, 100), (3, 5, 1, 333)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_kv_splits_deterministic_and_no_empty_split(shape):
    """A function of the shapes alone; at least one split; ranges of
    ceil(n_tiles / splits) >= 2 tiles, none empty; one split wherever there
    are several query tiles or the blocks already fill the SMs."""
    from repro_torch.kernels.flashattn.kernel import BLOCK_K, SMS, kv_splits

    b, kvh, n_qt, sk = shape
    s = kv_splits(*shape)
    assert s == kv_splits(*shape) and isinstance(s, int) and s >= 1
    n_kt = -(-sk // BLOCK_K)
    if s > 1:
        per = -(-n_kt // s)
        assert per >= 2 and (s - 1) * per < n_kt
        assert n_qt == 1 and b * kvh < SMS
        assert b * kvh * s <= 2 * SMS + b * kvh  # about two blocks per SM
    if n_qt != 1 or b * kvh * n_qt >= SMS:
        assert s == 1


def _old_twin(q, k, v, q_pos, kv_pos, exp_tab, recip_tab, *, causal, window,
              scale, block_k, block_q):
    """The tile twin's loop as it stood before key splits (one range)."""
    from repro_torch.kernels.flashattn.ref import (LOG2E, M_FLOOR, NEG,
                                                   _chunk_live, _mask,
                                                   table_exp_neg,
                                                   table_recip)

    n, sq, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    qf = q.to(torch.float32) * scale
    m = torch.full((n, sq, 1), M_FLOOR, dtype=torch.float32)
    l = torch.zeros((n, sq, 1), dtype=torch.float32)
    acc = torch.zeros((n, sq, v.shape[-1]), dtype=torch.float32)
    for k0 in range(0, k.shape[1], block_k):
        sl = slice(k0, k0 + block_k)
        s = torch.einsum("nqd,nkd->nqk", qf, k[:, sl].to(torch.float32))
        s = torch.where(_mask(q_pos, kv_pos[:, sl], causal, window), s,
                        torch.full_like(s, NEG))
        m_new = torch.clamp(torch.maximum(m, s.amax(-1, keepdim=True)),
                            min=M_FLOOR)
        p = table_exp_neg((m_new - s) * LOG2E, *exp_tab)
        corr = table_exp_neg((m_new - m) * LOG2E, *exp_tab)
        pv = torch.einsum("nqk,nkd->nqd", p.to(v.dtype).to(torch.float32),
                          v[:, sl].to(torch.float32))
        acc_new = acc * corr + pv
        l_new = l * corr + p.sum(-1, keepdim=True)
        if block_q is None:
            m, l, acc = m_new, l_new, acc_new
        else:
            live = _chunk_live(q_pos, kv_pos[:, sl], causal, window, block_q)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live, acc_new, acc)
    recip = table_recip(torch.clamp(l, min=1e-30), *recip_tab)
    return (acc * recip).to(v.dtype)


@pytest.mark.parametrize("window,block_q", [(None, None), (None, 4),
                                            (6, 4), (None, 1)])
def test_split_twin_one_split_is_the_old_twin(window, block_q, libs):
    """``kv_splits=1`` (the default) is the tile twin as it was, bitwise."""
    from repro_torch.kernels.flashattn.ref import _flash_chunks
    from repro_torch.kernels.interp.ops import lib_meta

    lib, _ = libs
    rng = np.random.default_rng(31)
    n, sq, sk, d = 4, 9, 70, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((n, s, d)).astype(
        np.float32)) for s in (sq, sk, sk))
    q_pos = torch.arange(sk - sq, sk, dtype=torch.int32).expand(n, sq)
    kv_pos = torch.arange(sk, dtype=torch.int32).expand(n, sk).clone()
    kv_pos[1, 20:] = -1
    kv_pos[2, ::3] = -1
    tabs = ((lib.coeffs, lib_meta(lib, "exp2neg")),
            (lib.coeffs, lib_meta(lib, "recip")))
    kw = dict(causal=True, window=window, scale=None, block_k=8,
              block_q=block_q)
    want = _old_twin(q, k, v, q_pos, kv_pos, *tabs, **kw)
    assert torch.equal(_flash_chunks(q, k, v, q_pos, kv_pos, *tabs, **kw),
                       want)
    assert torch.equal(_flash_chunks(q, k, v, q_pos, kv_pos, *tabs,
                                     kv_splits=1, **kw), want)


def test_dead_split_adds_exactly_zero(libs):
    """A split whose tiles were all skipped (m = M_FLOOR, l = 0, acc = 0)
    changes neither l nor acc of the combine."""
    from repro_torch.kernels.flashattn.ref import M_FLOOR, _combine
    from repro_torch.kernels.interp.ops import lib_meta

    lib, _ = libs
    rng = np.random.default_rng(5)
    live = (torch.from_numpy(rng.standard_normal((2, 3, 1)).astype(
        np.float32)), torch.from_numpy(rng.random((2, 3, 1)).astype(
            np.float32) * 5), torch.from_numpy(rng.standard_normal(
                (2, 3, 8)).astype(np.float32)))
    dead = (torch.full((2, 3, 1), M_FLOOR), torch.zeros(2, 3, 1),
            torch.zeros(2, 3, 8))
    tab = (lib.coeffs, lib_meta(lib, "exp2neg"))
    l1, acc1 = _combine([live], tab)
    for parts in ([live, dead], [dead, live], [dead, live, dead]):
        l, acc = _combine(parts, tab)
        assert torch.equal(l, l1) and torch.equal(acc, acc1)


def _split_case(case, seed):
    """(N, Sq, H, KVH, D, Sk) inputs of a split-twin case with positions and
    window: decode rows whose cache lengths leave whole splits dead, a
    sliding window that kills the early splits, and a GQA prefill."""
    rng = np.random.default_rng(seed)
    b, sq, h, kvh, d, sk = {"dead_splits": (3, 1, 4, 2, 16, 64),
                            "window": (2, 1, 4, 1, 8, 64),
                            "prefill": (1, 24, 4, 2, 16, 64)}[case]
    q, k, v = _qkv(seed, b, sq, sk, h, kvh, d)
    kv_pos = _arange(b, sk)
    window = None
    if case == "dead_splits":
        q_pos = np.array([[5], [40], [63]], np.int32)
        kv_pos[0, 6:] = -1  # splits past the first hold no live key
        kv_pos[1, 41:] = -1
        kv_pos[2, 10:30] = -1  # a dead stretch inside the cache
    elif case == "window":
        q_pos = np.array([[63], [50]], np.int32)
        kv_pos[1, 51:] = -1
        window = 10
    else:
        q_pos = _arange(b, sq, start=sk - sq)
    return q, k, v, q_pos, kv_pos, window


def split_twin_vs_oracle(lib, jlib, case, splits, seed=0):
    """The split twin (8-key tiles, the kernel's query tile) against the
    reference's unchunked ``flash_attention_lib_ref`` through JAX; returns
    (max error, tolerance (n_tiles + 2) * bound * max|v|)."""
    from repro_torch.kernels.flashattn.kernel import query_tile
    from repro_torch.kernels.flashattn.ref import attention_fused_library_ref

    q, k, v, q_pos, kv_pos, window = _split_case(case, seed)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)]
    tq = query_tile(q.shape[1], q.shape[2] // k.shape[2], v.shape[-1])
    got = attention_fused_library_ref(
        *t[:3], lib, q_pos=t[3], kv_pos=t[4], window=window, block_k=8,
        block_q=tq, kv_splits=splits).numpy()
    ref = jax.jit(functools.partial(jax_attention, use_kernel=False,
                                    window=window))
    want = np.asarray(ref(*(jnp.asarray(a) for a in (q, k, v)), jlib,
                          q_pos=jnp.asarray(q_pos),
                          kv_pos=jnp.asarray(kv_pos)))
    n_tiles = -(-k.shape[1] // 8)
    bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    return float(np.abs(got - want).max()), \
        (n_tiles + 2) * bound * np.abs(v).max()


@pytest.mark.parametrize("splits", [2, 3, 4])
@pytest.mark.parametrize("case", ["dead_splits", "window", "prefill"])
def test_split_twin_matches_reference_oracle(case, splits, libs):
    """At 2-4 key splits the twin stays within the chunked tolerance of the
    reference's unfused oracle on the default (R6) library."""
    lib, jlib = libs
    err, tol = split_twin_vs_oracle(lib, jlib, case, splits)
    assert err <= tol, (err, tol)
