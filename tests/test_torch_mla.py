"""MLA (``minicpm3_4b`` smoke, float32) under per-layer plans and the AOT
serving tier, against the reference and inside the port.

* Plans: MLA's ``q_norm`` / ``kv_norm`` go through the layer's rmsnorm
  site, as in the reference: a plan whose rmsnorm site is exact and whose
  other sites are interp-fused gives the reference's prefill logits under
  the same plan (4 * 2^-12 * max|logit|, greedy tokens equal where the
  reference's top-2 gap clears twice that), with four rmsnorm-site calls
  per layer; the uniform interp-fused plan is the homogeneous backend
  bitwise (prefill logits and caches, an engine's streams and caches).
* AOT: ``prefill_padded`` against the reference's (the tolerance above;
  exact numerics 2e-5; latents at 10x), padded ≡ exact-length inside the
  port at that tolerance with equal greedy tokens and bitwise positions,
  and an AOT engine whose counters equal the reference AOT engine's, with
  zero misses and every stream bitwise a one-slot exact-length engine's.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as jplan
import repro_torch.plan as tplan
from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.serve import engine as jengine
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics
from repro_torch.plan.numerics import SiteNumerics
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "minicpm3_4b"
CACHE = 48
MAX_NEW = 5
AOT_KEYS = ("aot_hits", "aot_misses", "aot_fallbacks", "aot_reshards",
            "packed_admits", "packed_requests", "admit_dispatches",
            "dispatches", "transfers", "ticks", "decode_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jax_smoke_config(ARCH)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    cfg = get_smoke_config(ARCH)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@functools.lru_cache(maxsize=None)
def _libs():
    return default_explorer().compile(), InterpLibrary.default_library("cpu")


def _tol(numerics, logits):
    return (2e-5 if numerics == "exact"
            else 4 * 2.0 ** -12 * np.abs(logits).max())


def _greedy(want, got, tol):
    ref = want.reshape(-1, want.shape[-1])
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(ref.argmax(-1)[clear],
                                  got.reshape(ref.shape).argmax(-1)[clear])


def _stacked(jcache, jcfg):
    parts = []
    for i, seg in enumerate(jtf.layer_plan(jcfg)):
        c = jcache[f"seg{i}"]["0"]
        parts.append([np.asarray(t) if seg.repeat > 1 else np.asarray(t)[None]
                      for t in c])
    return [np.concatenate(ts) for ts in zip(*parts)]


def _exact_norm_plan(P, n_layers):
    """Softmax and activation sites interp-fused, the rmsnorm site exact,
    in every layer; ``rest`` interp-fused."""
    fused = P.SiteAssign("interp-fused")
    layer = P.LayerAssign(fused, P.SiteAssign("exact"), fused)
    rest = P.LayerAssign(fused, fused, fused)
    return P.NumericsPlan(layers=(layer,) * n_layers, rest=rest)


def test_mla_norms_take_the_layers_rmsnorm_site(monkeypatch):
    jcfg, jparams, cfg, params = _model()
    jlib, lib = _libs()
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jc = jcfg.replace(plan=_exact_norm_plan(jplan, cfg.n_layers))
    want = np.asarray(jtf.prefill(jparams, tokens, jc,
                                  jax_get_numerics(jc, {"default": jlib}),
                                  16)[0])
    c = cfg.replace(plan=_exact_norm_plan(tplan, cfg.n_layers))
    calls = []
    real = SiteNumerics.rmsnorm
    monkeypatch.setattr(SiteNumerics, "rmsnorm", lambda self, x, g, eps=1e-6:
                        calls.append(x.shape[-1]) or real(self, x, g, eps))
    with torch.inference_mode():
        got, _ = tf.prefill(params, torch.as_tensor(tokens, dtype=torch.int64),
                            c, get_numerics(c, {"default": lib}), 16)
    got = got.numpy()
    tol = _tol("interp-fused", want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    _greedy(want, got, tol)
    m = cfg.mla
    assert sorted(calls) == sorted(
        [cfg.d_model, m.q_lora_rank, m.kv_lora_rank, cfg.d_model]
        * cfg.n_layers)


def test_mla_uniform_plan_is_the_homogeneous_backend_bitwise():
    _, _, cfg, params = _model()
    lib = _libs()[1]
    pc = cfg.replace(plan=tplan.NumericsPlan.uniform("interp-fused",
                                                     cfg.n_layers))
    hc = cfg.replace(numerics="interp-fused")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 9)), dtype=torch.int64)
    with torch.inference_mode():
        a, ca = tf.prefill(params, tokens, pc,
                           get_numerics(pc, {"default": lib}), 16)
        b, cb = tf.prefill(params, tokens, hc, get_numerics(hc, lib), 16)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 3)]
    outs = {}
    for name, c, library in (("plan", pc, {"default": lib}),
                             ("homogeneous", hc, lib)):
        eng = ServeEngine(c, params, slots=2, cache_len=CACHE,
                          library=library, device="cpu")
        for i, pr in enumerate(prompts):
            eng.submit(Request(i, pr, max_new=MAX_NEW))
        outs[name] = ({r.rid: r.out for r in eng.run()}, eng.caches)
    assert outs["plan"][0] == outs["homogeneous"][0]
    assert all(torch.equal(x, y) for x, y in
               zip(outs["plan"][1], outs["homogeneous"][1]))


def _padded_inputs(cfg, lens, bucket, seed=11):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lens), bucket), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return tokens, np.asarray(lens, np.int32)


@pytest.mark.parametrize("numerics", ["exact", "interp-fused"])
def test_mla_prefill_padded_matches_reference(numerics):
    jcfg, jparams, cfg, params = _model()
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
    assert (cache.pos.numpy()[:, 2, 1:] == -1).all()
    for got_t, want_t in ((cache.k, jk), (cache.v, jv)):
        np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0,
                                   atol=10 * tol)


@pytest.mark.parametrize("numerics", ["exact", "interp-fused"])
def test_mla_padded_prefill_is_exact_length(numerics):
    """Each padded row against an exact-length prefill of its prompt:
    logits within the model tests' tolerance and the same greedy token,
    latents at 10x, positions bitwise and the pad tail dead."""
    _, _, cfg, params = _model()
    num = get_numerics(numerics, _libs()[1] if numerics != "exact" else None)
    lens = (5, 16, 2, 11)
    tokens, tl = _padded_inputs(cfg, lens, 16)
    with torch.inference_mode():
        got, cache = tf.prefill_padded(
            params, torch.as_tensor(tokens, dtype=torch.int64),
            torch.as_tensor(tl), cfg, num, 32)
        for i, n in enumerate(lens):
            want, one = tf.prefill(
                params, torch.as_tensor(tokens[i:i + 1, :n],
                                        dtype=torch.int64), cfg, num, 32)
            w = want[0].numpy()
            tol = _tol(numerics, w)
            np.testing.assert_allclose(got[i].numpy(), w, rtol=0, atol=tol)
            assert int(got[i].argmax()) == int(w.argmax()), (i, n)
            for a, b in ((cache.k, one.k), (cache.v, one.v)):
                np.testing.assert_allclose(a[:, i, :n].numpy(),
                                           b[:, 0, :n].numpy(), rtol=0,
                                           atol=10 * tol)
            assert torch.equal(cache.pos[:, i], one.pos[:, 0])
            assert (cache.pos[:, i, n:] == -1).all()


def _serve_port(prompts, numerics, **kw):
    _, _, cfg, params = _model()
    lib = _libs()[1] if numerics != "exact" else None
    eng = ServeEngine(cfg.replace(numerics=numerics), params,
                      cache_len=CACHE, library=lib, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new=MAX_NEW))
    return {r.rid: list(r.out) for r in eng.run()}, eng


@pytest.mark.parametrize("numerics", ["exact", "interp-fused"])
def test_mla_aot_engine_counts_as_the_reference_with_zero_misses(numerics):
    """An AOT engine on MLA (``aot_buckets=(8, 16)``, packs of up to 4):
    the reference AOT engine's counters on the same prompts, zero misses,
    a packed admission, and every stream bitwise a one-slot exact-length
    engine's."""
    jcfg, jparams, cfg, _ = _model()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 16, 3, 9, 30, 8)]
    kw = dict(slots=3, aot_buckets=(8, 16), max_pack=4)
    got, eng = _serve_port(prompts, numerics, **kw)
    jeng = jengine.ServeEngine(
        jcfg.replace(numerics="exact" if numerics == "exact" else "interp"),
        jparams, cache_len=CACHE,
        library=_libs()[0] if numerics != "exact" else None, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(jengine.Request(i, p, max_new=MAX_NEW))
    jeng.run()
    assert {k: eng.stats[k] for k in AOT_KEYS} == \
        {k: jeng.stats[k] for k in AOT_KEYS}
    assert eng.stats["aot_misses"] == 0 and eng.stats["packed_requests"] > 0
    assert eng.stats["aot_fallbacks"] == 1  # the 30-token prompt
    for i, p in enumerate(prompts):
        solo, _ = _serve_port([p], numerics, slots=1)
        assert got[i] == solo[0], f"request {i} (len {len(p)}) diverged"
