"""The port's AOT serving tier (``repro_torch.serve.aot``, bucketed packed
admission, ``models.transformer.prefill_padded``) against the reference's
(``repro.serve.aot``, ``tests/serve/test_aot_buckets.py``), on the smoke
configs with the reference's parameters.

* The bucket table, pack sizes, tick chunks and program counts equal the
  reference's functions.
* ``prefill_padded`` / ``mask_cache_tail`` / ``extract_cache_row`` against
  the reference on smoke Yi-6B and DeepSeekMoE: positions bitwise (integer
  masks), logits and K/V within the model tests' tolerances (exact
  numerics atol 2e-5 on logits of scale ~3, float32 reassociation;
  interp-fused 4 * 2^-12 * max|logit|; K/V 10x that), greedy tokens equal
  where the reference's top-2 gap clears twice the tolerance.
* Inside the port, bitwise: a padded prefill's real rows equal an
  exact-length prefill of each prompt on the dense model (logits, K/V and
  positions of the real rows; the pad tail masked dead). On DeepSeekMoE
  only where the two expert capacities agree: the capacity comes from the
  bucket length, as in the reference, so a padded MoE prefill is held
  against the reference's ``prefill_padded``, not against exact length.
* The reference's engine cases on the port (boundary prompts, the
  exact-length fallback, mixed buckets against the solo oracle, zero
  misses), with the reference's engine beside it on the same requests:
  its AOT counters and the streams agree (exact numerics bitwise; the
  interp runs and DeepSeekMoE tie-aware). ``aot_compiles`` counts what
  each port engine prepared (``compile_count``); the reference's counts
  fresh compiles of its process-wide cache.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.serve import aot as jaot
from repro.serve import engine as jengine
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics
from repro_torch.serve import aot
from repro_torch.serve.engine import Request, ServeEngine

MAX_NEW = 5
CACHE = 48
ARCHS = ["yi_6b", "deepseek_moe_16b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch: str):
    jcfg = jax_smoke_config(arch)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    cfg = get_smoke_config(arch)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@functools.lru_cache(maxsize=None)
def _libs():
    return default_explorer().compile(), InterpLibrary.default_library("cpu")


def _tol(numerics, logits):
    return 2e-5 if numerics == "exact" else \
        4 * 2.0 ** -12 * np.abs(logits).max()


def _greedy(ref, got, tol):
    ref = ref.reshape(-1, ref.shape[-1])
    got = got.reshape(ref.shape)
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(ref.argmax(-1)[clear], got.argmax(-1)[clear])


def _stacked(jcache, jcfg) -> list[np.ndarray]:
    """The reference's per-segment caches as the port's one (k, v, pos)
    stack over all layers."""
    parts = []
    for i, seg in enumerate(jtf.layer_plan(jcfg)):
        c = jcache[f"seg{i}"]["0"]
        parts.append([np.asarray(t) if seg.repeat > 1 else np.asarray(t)[None]
                      for t in c])
    return [np.concatenate(ts) for ts in zip(*parts)]


# --------------------------------------------------------------- the table

@pytest.mark.parametrize("buckets", [(8, 16, 32), (16,), (1, 2, 3, 512)])
def test_bucket_table_equals_the_reference(buckets):
    got, want = aot.BucketTable(buckets), jaot.BucketTable(buckets)
    assert got.buckets == want.buckets
    for n in range(0, max(buckets) + 3):
        assert got.bucket_for(n) == want.bucket_for(n)
    for cache in (1, 4, 20, 48, 600, 1024):
        assert (aot.BucketTable.for_cache(cache, buckets).buckets
                == jaot.BucketTable.for_cache(cache, buckets).buckets)
        assert (aot.BucketTable.for_cache(cache).buckets
                == jaot.BucketTable.for_cache(cache).buckets)
    assert aot.DEFAULT_BUCKETS == jaot.DEFAULT_BUCKETS


@pytest.mark.parametrize("bad", [(), (16, 8), (8, 8), (0, 8)])
def test_bucket_table_refuses_what_the_reference_refuses(bad):
    for mod in (aot, jaot):
        with pytest.raises(ValueError):
            mod.BucketTable(bad)


def test_pack_chunk_and_program_counts_equal_the_reference():
    for max_pack in range(0, 10):
        for slots in range(1, 10):
            assert aot.pack_sizes(max_pack, slots) == \
                jaot.pack_sizes(max_pack, slots)
    for horizon in range(0, 20):
        assert aot.tick_chunk_sizes(horizon) == \
            jaot.tick_chunk_sizes(horizon)
    for buckets in ((8, 16), (16, 32, 64, 128, 256, 512)):
        for max_pack, slots, horizon in ((4, 8, 8), (8, 3, 6), (1, 1, 1)):
            assert aot.compile_count(aot.BucketTable(buckets), max_pack,
                                     slots, horizon) == \
                jaot.compile_count(jaot.BucketTable(buckets), max_pack,
                                   slots, horizon)


# ---------------------------------------------------------- padded prefill

def _padded_inputs(cfg, lens, bucket, seed=11):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), bucket), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return tokens, np.asarray(lens, np.int32)


@pytest.mark.parametrize("numerics", ["exact", "interp-fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_padded_matches_reference(arch, numerics):
    jcfg, jparams, cfg, params = _model(arch)
    jlib, lib = _libs()
    interp = numerics != "exact"
    tokens, lens = _padded_inputs(cfg, (5, 16, 1, 11), 16)
    want, jcache, _ = jtf.prefill_padded(
        jparams, jnp.asarray(tokens), jnp.asarray(lens), jcfg,
        jax_get_numerics(numerics, jlib if interp else None), 24)
    want = np.asarray(want)
    with torch.inference_mode():
        got, cache = tf.prefill_padded(
            params, torch.as_tensor(tokens, dtype=torch.int64),
            torch.as_tensor(lens), cfg,
            get_numerics(numerics, lib if interp else None), 24)
    tol = _tol(numerics, want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    _greedy(want, got.numpy(), tol)
    jk, jv, jpos = _stacked(jcache, jcfg)
    np.testing.assert_array_equal(cache.pos.numpy(), jpos)
    assert (cache.pos.numpy()[:, 2, 1:] == -1).all()  # 1-token row's tail
    for got_t, want_t in ((cache.k, jk), (cache.v, jv)):
        np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0,
                                   atol=10 * tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_mask_cache_tail_and_extract_row_match_reference(arch):
    """Integer position masks and row slices: bitwise the reference's."""
    jcfg, jparams, cfg, params = _model(arch)
    tokens, lens = _padded_inputs(cfg, (3, 8, 6), 8)
    _, jcache, _ = jtf.prefill(jparams, jnp.asarray(tokens), jcfg,
                               jax_get_numerics("exact"), 12)
    with torch.inference_mode():
        _, cache = tf.prefill(params, torch.as_tensor(tokens,
                                                      dtype=torch.int64),
                              cfg, get_numerics("exact"), 12)
    jmask = jtf.mask_cache_tail(jcache, jnp.asarray(lens))
    mask = tf.mask_cache_tail(cache, torch.as_tensor(lens))
    np.testing.assert_array_equal(mask.pos.numpy(), _stacked(jmask, jcfg)[2])
    assert mask.k is cache.k and mask.v is cache.v
    for i in range(len(lens)):
        jrow = _stacked(jtf.extract_cache_row(jcfg, jmask, i), jcfg)
        for idx in (i, torch.tensor(i)):
            row = tf.extract_cache_row(cfg, mask, idx)
            assert row.k.shape[1] == 1
            np.testing.assert_array_equal(row.pos.numpy(), jrow[2])
            np.testing.assert_allclose(row.k.numpy(), jrow[0], rtol=0,
                                       atol=1e-4)


@pytest.mark.parametrize("numerics", ["exact", "interp-fused", "interp"])
@pytest.mark.parametrize("bucket,lens", [(16, (5, 16, 2, 11)),
                                         (128, (5, 70, 128))])
def test_padded_prefill_is_exact_length_bitwise_dense(numerics, bucket,
                                                      lens):
    """Inside the port on the dense model: each padded row's positions
    below its true length are bitwise an exact-length prefill's and the pad
    tail's are -1; its logits agree within the model tests' float tolerance
    (atol 2e-5 on exact, 4 table codes of the largest logit on the table
    paths; K/V at 10x), with the same greedy token. The padded prefill
    reduces over dead pad keys and runs many-row products, which CPU BLAS
    and the attention's reductions sum in another order than the
    exact-length ones."""
    _, _, cfg, params = _model("yi_6b")
    lib = _libs()[1]
    num = get_numerics(numerics, lib if numerics != "exact" else None)
    tokens, tl = _padded_inputs(cfg, lens, bucket)
    with torch.inference_mode():
        got, cache = tf.prefill_padded(
            params, torch.as_tensor(tokens, dtype=torch.int64),
            torch.as_tensor(tl), cfg, num, 160)
        for i, n in enumerate(lens):
            want, one = tf.prefill(
                params, torch.as_tensor(tokens[i:i + 1, :n],
                                        dtype=torch.int64), cfg, num, 160)
            w = want[0].numpy()
            tol = (2e-5 if numerics == "exact"
                   else 4 * 2.0 ** -12 * np.abs(w).max())
            np.testing.assert_allclose(got[i].numpy(), w, rtol=0, atol=tol,
                                       err_msg=f"row {i} len {n}")
            assert int(got[i].argmax()) == int(w.argmax()), (i, n)
            for a, b in ((cache.k, one.k), (cache.v, one.v)):
                np.testing.assert_allclose(a[:, i, :, :n].numpy(),
                                           b[:, 0, :, :n].numpy(), rtol=0,
                                           atol=10 * tol)
            assert torch.equal(cache.pos[:, i], one.pos[:, 0])
            assert (cache.pos[:, i, n:] == -1).all()


def test_one_token_prompt_padded_within_float_tolerance():
    """A one-token prompt's exact-length prefill is one-row products
    throughout, which CPU BLAS sums in another order than the padded
    prefill's many-row ones: its row agrees within float32 reassociation
    (atol 2e-5 on logits, as the model tests), with the same greedy token
    and positions."""
    _, _, cfg, params = _model("yi_6b")
    num = get_numerics("exact")
    tokens, tl = _padded_inputs(cfg, (1, 6), 16)
    with torch.inference_mode():
        got, cache = tf.prefill_padded(
            params, torch.as_tensor(tokens, dtype=torch.int64),
            torch.as_tensor(tl), cfg, num, 24)
        want, one = tf.prefill(params, torch.as_tensor(
            tokens[:1, :1], dtype=torch.int64), cfg, num, 24)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=2e-5)
    assert int(got[0].argmax()) == int(want[0].argmax())
    assert torch.equal(cache.pos[:, 0], one.pos[:, 0])


def test_moe_padded_prefill_capacity_comes_from_the_bucket():
    """DeepSeekMoE sizes its expert capacity from the bucket length (as
    the reference): a 9-token prompt in bucket 16 dispatches with capacity
    7, at exact length with 4. Where the two agree (a 5-token prompt in
    bucket 8: both 4) the padded row is the exact-length one within float
    tolerance (atol 2e-5, as the model tests), with the same greedy
    token."""
    _, _, cfg, params = _model("deepseek_moe_16b")
    assert moe._capacity(16, cfg) == 7 and moe._capacity(9, cfg) == 4
    assert moe._capacity(8, cfg) == moe._capacity(5, cfg) == 4
    num = get_numerics("exact")
    tokens, tl = _padded_inputs(cfg, (5,), 8)
    with torch.inference_mode():
        got, _ = tf.prefill_padded(params, torch.as_tensor(
            tokens, dtype=torch.int64), torch.as_tensor(tl), cfg, num, 16)
        want, _ = tf.prefill(params, torch.as_tensor(
            tokens[:, :5], dtype=torch.int64), cfg, num, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    assert int(got.argmax()) == int(want.argmax())


def test_prefill_padded_refuses_what_the_reference_refuses():
    """The port's configs have no sliding window, encoder, frontend or SSM
    field yet; a config that carries one is refused as the reference
    refuses it."""
    _, _, cfg, params = _model("yi_6b")

    class Windowed:
        def __init__(self, **kw):
            self.__dict__.update(kw)

        def __getattr__(self, name):
            return getattr(cfg, name)

    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for kw, match in (({"sliding_window": 4}, "sliding-window"),
                      ({"encoder": object()}, "encoder"),
                      ({"frontend": "vision_stub"}, "encoder/frontend")):
        with pytest.raises(ValueError, match=match):
            tf.prefill_padded(params, tokens, [4], Windowed(**kw),
                              get_numerics("exact"), 8)


# ------------------------------------------------------------ the engines

def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


AOT_KEYS = ("aot_hits", "aot_misses", "aot_fallbacks", "aot_reshards",
            "packed_admits", "packed_requests", "admit_dispatches",
            "dispatches", "transfers", "ticks", "decode_steps")


def _serve_port(arch, prompts, numerics="exact", **kw):
    _, _, cfg, params = _model(arch)
    c = cfg.replace(numerics=numerics)
    lib = _libs()[1] if numerics != "exact" else None
    eng = ServeEngine(c, params, cache_len=CACHE, library=lib, device="cpu",
                      **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new=MAX_NEW))
    return {r.rid: list(r.out) for r in eng.run()}, eng


def _serve_ref(arch, prompts, numerics="exact", **kw):
    jcfg, jparams, _, _ = _model(arch)
    c = jcfg.replace(numerics=numerics)
    lib = _libs()[0] if numerics != "exact" else None
    eng = jengine.ServeEngine(c, jparams, cache_len=CACHE, library=lib, **kw)
    for i, p in enumerate(prompts):
        eng.submit(jengine.Request(i, p, max_new=MAX_NEW))
    return {r.rid: list(r.out) for r in eng.run()}, eng


def _tie_aware(arch, numerics, ref, got, prompts):
    """Equal streams, or a first divergence where the reference's own
    logits (an exact-length prefill of the shared prefix) have a top-2 gap
    inside twice the logit tolerance."""
    jcfg, jparams, _, _ = _model(arch)
    c = jcfg.replace(numerics=numerics)
    num = jax_get_numerics(c, _libs()[0] if numerics != "exact" else None,
                           fused=numerics != "exact")
    assert set(ref) == set(got)
    for rid in ref:
        t = next((i for i, (x, y) in enumerate(zip(ref[rid], got[rid]))
                  if x != y), None)
        if t is None:
            assert len(ref[rid]) == len(got[rid])
            continue
        seq = np.concatenate([prompts[rid],
                              np.asarray(ref[rid][:t], np.int32)])
        logits = np.asarray(jtf.prefill(jparams, seq[None], c, num,
                                        64)[0])[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= 2 * _tol(numerics, logits)


def _against_reference(arch, prompts, numerics="exact", **kw):
    got, eng = _serve_port(arch, prompts, numerics, **kw)
    want, jeng = _serve_ref(arch, prompts, numerics, **kw)
    assert {k: eng.stats[k] for k in AOT_KEYS} == \
        {k: jeng.stats[k] for k in AOT_KEYS}
    if numerics == "exact" and arch == "yi_6b":
        assert got == want
    else:
        _tie_aware(arch, numerics, want, got, prompts)
    return got, eng


def test_prompt_exactly_at_bucket_boundary():
    _, _, cfg, _ = _model("yi_6b")
    prompts = _prompts(cfg, (8, 16), 3)
    got, eng = _against_reference("yi_6b", prompts, slots=2,
                                  aot_buckets=(8, 16))
    ref, _ = _serve_port("yi_6b", prompts, slots=2)
    assert got == ref
    assert eng.stats["aot_fallbacks"] == 0
    assert eng.stats["aot_misses"] == 0
    assert eng.stats["aot_compiles"] == aot.compile_count(
        eng.aot_buckets, 4, 2, 8)


def test_prompt_longer_than_largest_bucket_falls_back():
    _, _, cfg, _ = _model("yi_6b")
    prompts = _prompts(cfg, (20, 5), 4)
    got, eng = _against_reference("yi_6b", prompts, slots=2,
                                  aot_buckets=(8, 16))
    ref, _ = _serve_port("yi_6b", prompts, slots=2)
    assert got == ref
    assert eng.stats["aot_fallbacks"] == 1
    assert len(got[0]) == MAX_NEW


@pytest.mark.parametrize("numerics", ["exact", "interp"])
def test_mixed_bucket_admission_matches_solo_oracle(numerics):
    """More requests than slots across buckets and one fallback: admission
    order is the legacy loop's and every stream is its one-slot engine's
    (bitwise, inside the port), packed or not."""
    _, _, cfg, _ = _model("yi_6b")
    prompts = _prompts(cfg, (5, 16, 3, 9, 30, 8, 2, 11), 5)
    got, eng = _against_reference("yi_6b", prompts, numerics, slots=3,
                                  aot_buckets=(8, 16), max_pack=4)
    assert eng.stats["packed_requests"] > 0
    assert eng.stats["prefills"] == eng.stats["admit_dispatches"]
    for i, p in enumerate(prompts):
        solo, _ = _serve_port("yi_6b", [p], numerics, slots=1)
        assert got[i] == solo[0], f"request {i} (len {len(p)}) diverged"


def test_warm_engine_steady_state_has_zero_misses():
    _, _, cfg, _ = _model("yi_6b")
    prompts = _prompts(cfg, (4, 7, 12, 15), 6)
    got, eng = _against_reference("yi_6b", prompts, slots=4,
                                  aot_buckets=(8, 16))
    assert eng.stats["aot_misses"] == 0
    assert eng.stats["aot_hits"] > 0
    assert eng.stats["packed_admits"] == 2  # one group per bucket
    assert sum(len(v) for v in got.values()) == MAX_NEW * len(prompts)


def test_packed_admission_counts_launches_per_forward():
    """A packed admission is one prefill forward: the port counts it once
    in ``prefills`` (no kernel launches on the CPU)."""
    _, _, cfg, _ = _model("yi_6b")
    _, eng = _serve_port("yi_6b", _prompts(cfg, (3, 4, 5, 6), 8), "interp",
                         slots=4, aot_buckets=(8,), max_pack=4)
    assert eng.stats["packed_admits"] == 1 == eng.stats["prefills"]
    assert eng.stats["packed_requests"] == 4
    assert set(eng.stats["launches"].values()) == {0}


def test_degraded_engine_misses_and_still_serves():
    """A degradation changes the cfg (the key of every prepared program):
    later lookups miss, as the reference's, and the engine serves on."""
    _, _, cfg, params = _model("yi_6b")
    eng = ServeEngine(cfg.replace(numerics="interp"), params, slots=2,
                      cache_len=CACHE, library=_libs()[1], device="cpu",
                      aot_buckets=(8, 16))
    eng._degrade("test", to="exact")
    for i, p in enumerate(_prompts(cfg, (5, 7), 9)):
        eng.submit(Request(i, p, max_new=3))
    done = eng.run()
    assert len(done) == 2 and eng.stats["aot_misses"] > 0
    assert eng.stats["aot_hits"] == 0


def test_moe_packed_first_tokens_are_the_reference_prefill_padded():
    """DeepSeekMoE packed admission: the first tokens are the argmax of
    the reference's ``prefill_padded`` of each packed group (the bucket's
    capacity), tie-aware; the streams agree with the reference's AOT
    engine tie-aware, and its counters exactly."""
    jcfg, jparams, cfg, _ = _model("deepseek_moe_16b")
    prompts = _prompts(cfg, (5, 9, 14, 3), 12)
    got, eng = _against_reference("deepseek_moe_16b", prompts, "exact",
                                  slots=4, aot_buckets=(8, 16), max_pack=2)
    assert eng.stats["packed_admits"] == 2
    groups = {8: (0, 3), 16: (1, 2)}  # queue order -> slots, by bucket
    for bucket, rids in groups.items():
        tokens = np.zeros((len(rids), bucket), np.int32)
        for i, rid in enumerate(rids):
            tokens[i, :len(prompts[rid])] = prompts[rid]
        lens = np.asarray([len(prompts[r]) for r in rids], np.int32)
        logits, _, _ = jtf.prefill_padded(jparams, tokens, lens, jcfg,
                                          jax_get_numerics("exact"), CACHE)
        logits = np.asarray(logits)[:, 0]
        for i, rid in enumerate(rids):
            first = got[rid][0]
            gap = logits[i].max() - logits[i, first]
            assert gap <= 2 * _tol("exact", logits[i]), (rid, gap)
