"""Sliding-window attention in the port: the ring cache and the windowed
engine, against the reference and against the port's own oracles.

* The ring: a prompt longer than the window keeps its last ``s_eff`` rows,
  rotated so that row r holds the position p with p % s_eff == r. Held
  against the reference's ``gqa_prefill`` at every rotation class (s %
  s_eff of 0, 1, s_eff - 1, and s_eff < cache_len): positions bitwise, K
  / V within float32 reassociation (atol 1e-4 on activations of scale ~1).
* The glue path cuts a prime length into full chunks and a shorter last
  one, against the reference's ``attention_core`` at exact numerics.
* The wrap oracle (twin of the reference's
  ``test_windowed_wrap_decode_matches_refill_oracle``): decoding past a
  clipped windowed prefill equals re-prefilling the grown sequence, in
  both packages, at the reference's tolerance (rtol = atol = 2e-2); the
  port's logits also stay within 2e-5 of the reference's.
* The engine (twins of the reference's windowed engine tests): a prompt
  past the window is served, ``cache_len < sliding_window`` is refused with
  the reference's message, the fused windowed wrap equals the solo oracle
  bitwise, ``submit``'s rejections match the reference's reason for
  reason, the graph decision reads the ring's rows, and a journaled
  windowed engine resumes to bitwise the uninterrupted streams.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.faults as jfaults
from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.serve.engine import Rejected as JaxRejected
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.faults import Crashed, arm_crashpoint, reset_crashpoints
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics
from repro_torch.serve.engine import Rejected, Request, ServeEngine
from repro_torch.serve.journal import load_requests

SMOKE_TOL = 2e-2  # the reference's wrap-oracle tolerance


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_crashpoints():
    reset_crashpoints()
    jfaults.reset_crashpoints()
    yield
    reset_crashpoints()
    jfaults.reset_crashpoints()


@functools.lru_cache(maxsize=None)
def _pair(arch: str, **variant):
    jcfg = jax_smoke_config(arch).replace(**variant)
    cfg = get_smoke_config(arch).replace(**variant)
    jparams = jtf.init_params(jax.random.key(1), jcfg)
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _yi16():
    return _pair("yi_6b", sliding_window=16)


@pytest.mark.parametrize("s,cache", [(16, 16), (17, 16), (31, 16),
                                     (37, 16), (21, 24), (40, 48)])
def test_windowed_prefill_ring_matches_reference(s, cache):
    """One layer's ``gqa_prefill`` on a window of 16: the kept rows and
    their rotation (s % s_eff = 0, 1, 15, 5; a cache wider than the window
    keeps only the window; a prompt inside the ring is not rotated)."""
    jcfg, cfg, jparams, params = _yi16()
    w = cfg.sliding_window
    p = tf.layer_params(params, cfg, 0)[1]["mixer"]
    jp = jax.tree.map(lambda a: a[0], jparams["segments"]["seg0"]["0"]
                      ["mixer"])
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    num = get_numerics("exact")
    y, c = attn.gqa_prefill(p, torch.from_numpy(x),
                            torch.from_numpy(positions.copy()), cfg, num,
                            cache)
    jy, jc = jattn.gqa_prefill(jp, jnp.asarray(x), jnp.asarray(positions),
                               jcfg, jax_get_numerics("exact"), cache)
    s_eff = min(cache, w)
    assert c.pos.shape == (2, s_eff) == attn.gqa_cache_specs(
        cfg, 2, cache, torch.float32).pos.shape
    np.testing.assert_array_equal(c.pos.numpy(), np.asarray(jc.pos))
    if s >= s_eff:
        assert (c.pos.numpy() % s_eff == np.arange(s_eff)).all()
        assert c.pos.min() == s - s_eff and c.pos.max() == s - 1
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    for got, want in ((c.k, jc.k), (c.v, jc.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("window", [None, 11])
def test_glue_cuts_a_prime_length_with_a_shorter_last_chunk(window):
    """``attention_core``'s glue path over 37 queries and keys (a prime) in
    chunks of 8 runs five chunks each way, the last of 5 (the reference's
    divisor chunking would run 37 one-key chunks): 5 x 5 blocks, two
    ``exp_neg`` calls each. The output equals the reference's at exact
    numerics within float32 reassociation (atol 1e-5 on unit-scale
    values)."""
    rng = np.random.default_rng(37)
    q, k, v = (rng.standard_normal((1, 37, 4, 16)).astype(np.float32)
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    pos = np.arange(37, dtype=np.int32)[None]
    calls = []

    class Counted(type(get_numerics("exact"))):
        def exp_neg(self, x):
            calls.append(tuple(x.shape))
            return super().exp_neg(x)

    got = attn.attention_core(*map(torch.from_numpy, (q, k, v, pos, pos)),
                              Counted(), window=window, q_chunk=8,
                              kv_chunk=8)
    want = jattn.attention_core(*map(jnp.asarray, (q, k, v, pos, pos)),
                                jax_get_numerics("exact"), window=window,
                                q_chunk=8, kv_chunk=8)
    assert len(calls) == 2 * 5 * 5
    assert calls[-2][-2:] == (5, 5)  # the last query and key chunks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_unwindowed_prefill_still_refuses_an_overflowing_prompt():
    cfg = get_smoke_config("yi_6b")
    params = tf.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="exceeds cache_len"):
        tf.prefill(params, torch.zeros((1, 17), dtype=torch.long), cfg,
                   get_numerics("exact"), 16)
    with pytest.raises(ValueError, match="sliding-window"):
        tf.prefill_padded(params, torch.zeros((1, 8), dtype=torch.long), [8],
                          cfg.replace(sliding_window=16),
                          get_numerics("exact"), 16)


@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_windowed_wrap_decode_matches_refill_oracle(name):
    """Yi smoke with a 16-token window, a prompt of w + 5: three decodes
    past the wrap against re-prefilling the grown sequence (which masks by
    window with no wrap at all), in both packages, and the port's logits
    against the reference's."""
    jcfg, cfg, jparams, params = _yi16()
    interp = name != "exact"
    jnum = jax_get_numerics(name,
                            default_explorer().compile() if interp else None)
    num = get_numerics(name, InterpLibrary.default_library("cpu")
                       if interp else None)
    w = cfg.sliding_window
    s = w + 5
    seq = np.random.default_rng(4).integers(0, cfg.vocab_size, s).astype(
        np.int32)
    log, cache = tf.prefill(params, torch.from_numpy(seq)[None].long(), cfg,
                            num, w)
    jlog, jcache, _ = jtf.prefill(jparams, jnp.asarray(seq)[None], jcfg, jnum,
                                  w)
    tok = int(np.asarray(jlog)[0, -1].argmax())
    for i in range(3):
        log, cache = tf.decode_step(params, torch.tensor([[tok]]),
                                    torch.tensor(s + i), cache, cfg, num)
        jlog, jcache = jtf.decode_step(jparams, jnp.asarray([[tok]]),
                                       jnp.asarray(s + i, jnp.int32), jcache,
                                       jcfg, jnum)
        seq = np.concatenate([seq, [tok]]).astype(np.int32)
        ref, _ = tf.prefill(params, torch.from_numpy(seq)[None].long(), cfg,
                            num, s + i + 1)
        jref, _, _ = jtf.prefill(jparams, jnp.asarray(seq)[None], jcfg, jnum,
                                 s + i + 1)
        got, want = log[:, 0].numpy(), np.asarray(jlog)[:, 0]
        np.testing.assert_allclose(got, ref[:, 0].numpy(), rtol=SMOKE_TOL,
                                   atol=SMOKE_TOL)
        np.testing.assert_allclose(want, np.asarray(jref)[:, 0],
                                   rtol=SMOKE_TOL, atol=SMOKE_TOL)
        tol = 2e-5 if name == "exact" else 4 * 2.0 ** -12 * np.abs(
            want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_array_equal(
            cache.pos.numpy(), np.asarray(jcache["seg0"]["0"].pos))
        tok = int(want[0].argmax())


def _mixtral(numerics="exact"):
    jcfg, cfg, jparams, params = _pair("mixtral_8x22b")
    return (jcfg.replace(numerics="interp" if numerics != "exact"
                         else "exact"),
            cfg.replace(numerics=numerics), jparams, params)


def _prompts(cfg, lengths, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _engine(cfg, params, slots=2, **kw):
    lib = (InterpLibrary.default_library("cpu") if cfg.numerics != "exact"
           else None)
    kw.setdefault("cache_len", cfg.sliding_window)
    return ServeEngine(cfg, params, slots=slots, library=lib, device="cpu",
                       **kw)


def test_windowed_engine_accepts_long_prompts_and_keeps_the_window():
    """Twin of ``test_sliding_window_engine_accepts_long_prompts``: a
    prompt of w + 8 is served; ``cache_len = w - 1`` is refused with the
    reference's message, on both packages."""
    jcfg, cfg, jparams, params = _mixtral()
    w = cfg.sliding_window
    eng = _engine(cfg, params, slots=1)
    eng.submit(Request(0, _prompts(cfg, (w + 8,))[0], max_new=3))
    (done,) = eng.run()
    assert len(done.out) == 3
    for make in (lambda: _engine(cfg, params, slots=1, cache_len=w - 1),
                 lambda: JaxEngine(jcfg, jparams, slots=1, cache_len=w - 1)):
        with pytest.raises(ValueError,
                           match="retain the full attention window"):
            make()


@pytest.mark.parametrize("numerics", ["exact", "interp-fused"])
def test_fused_windowed_wrap_matches_solo_oracle(numerics):
    """Twin of ``test_fused_engine_windowed_wrap``: a prompt past the
    window and a short one decode through the fused tick past the wrap;
    each stream bitwise the same engine serving the request alone."""
    _, cfg, _, params = _mixtral(numerics)
    w = cfg.sliding_window
    prompts = _prompts(cfg, (w + 8, 3, w - 2))
    eng = _engine(cfg, params)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new=6))
    done = {r.rid: r.out for r in eng.run()}
    assert eng.caches.pos.shape[-1] == w
    for i, p in enumerate(prompts):
        solo = _engine(cfg, params, slots=1)
        solo.submit(Request(i, p, max_new=6))
        (ref,) = solo.run()
        assert done[i] == ref.out, f"request {i} (len {len(p)}) diverged"


def _reason(submit):
    try:
        submit()
    except (Rejected, JaxRejected) as e:
        return e.reason
    return None


def test_windowed_submit_rejections_match_reference():
    """``submit`` on a windowed engine, reason for reason against the
    reference's: a prompt or a decode past the ring is accepted (no
    ``prompt_overflow`` / ``decode_overflow``), bad tokens, an empty prompt,
    an expired deadline and a full queue are refused."""
    jcfg, cfg, jparams, params = _mixtral()
    w = cfg.sliding_window
    clock = [0.0]
    port = _engine(cfg, params, max_queue=4, clock=lambda: clock[0])
    ref = JaxEngine(jcfg, jparams, slots=2, cache_len=w, max_queue=4,
                    clock=lambda: clock[0])
    cases = [(np.arange(3 * w) % cfg.vocab_size, 2, None),
             (np.arange(5), 4 * w, None),
             (np.zeros(0), 2, None),
             (np.array([1, cfg.vocab_size]), 2, None),
             (np.array([-1, 2]), 2, None),
             (np.arange(4), 2, -1.0),
             (np.arange(4), 2, None), (np.arange(4), 2, None),
             (np.arange(4), 2, None)]
    got = []
    for i, (prompt, max_new, deadline) in enumerate(cases):
        prompt = prompt.astype(np.int32)
        pair = [_reason(lambda: eng.submit(req(i, prompt, max_new=max_new,
                                               deadline=deadline)))
                for eng, req in ((port, Request), (ref, JaxRequest))]
        assert pair[0] == pair[1], (i, pair)
        got.append(pair[0])
    assert got == [None, None, "bad_prompt", "bad_prompt", "bad_prompt",
                   "deadline", None, None, "queue_full"]
    assert port.stats["rejected"] == ref.stats["rejected"] == 5


def test_graph_decision_reads_the_ring_rows(monkeypatch):
    """A windowed engine's cache is ``min(cache_len, window)`` rows, and the
    tick's graph decision asks ``decode_reads_host`` about those rows: with
    cache_len 32768 a 32-row ring would replay a graph, where 32768
    unwindowed rows take the glue path's host read."""
    _, cfg, _, params = _mixtral("interp-fused")
    asked = []
    real = attn.decode_reads_host
    monkeypatch.setattr(attn, "decode_reads_host",
                        lambda rows, num: asked.append(rows) or real(rows,
                                                                     num))
    eng = _engine(cfg, params, slots=1, cache_len=32768)
    assert tuple(eng.caches.k.shape[-2:]) == (cfg.sliding_window,
                                              cfg.head_size)
    eng.graph = True  # the CPU engine ticks eagerly: ask the rule itself
    assert eng._graph_blocker() is None and asked == [cfg.sliding_window]
    assert real(32768, eng.numerics)


@pytest.mark.parametrize("numerics", ["exact", "interp-fused"])
def test_windowed_journal_resume_is_bitwise(tmp_path, numerics):
    """A journaled windowed engine crashed mid-stream (after the second
    tick's emit, horizon 1) and resumed: the teacher-forced rebuild through
    the pool reproduces the ring, and every stream equals the
    uninterrupted run's."""
    _, cfg, _, params = _mixtral(numerics)
    w = cfg.sliding_window
    prompts = _prompts(cfg, (w + 8, 3, w - 2), seed=5)

    def submit(eng):
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new=8))

    eng = _engine(cfg, params, horizon=1)
    submit(eng)
    want = {r.rid: r.out for r in eng.run()}
    jp = tmp_path / "serve.jsonl"
    eng = _engine(cfg, params, horizon=1, journal=str(jp))
    arm_crashpoint("serve.tick.emitted", after=2)
    with pytest.raises(Crashed):
        submit(eng)
        eng.run()
    reset_crashpoints()
    pre = load_requests(jp)
    partial = [rid for rid, st in pre.items()
               if st.in_flight and 0 < len(st.out) < st.max_new]
    assert partial
    res = ServeEngine.resume(str(jp), cfg, params, slots=2, cache_len=w,
                             horizon=1, device="cpu",
                             library=_engine(cfg, params).library)
    res.run()
    final = load_requests(jp)
    assert {rid: st.out for rid, st in final.items()} == want
    assert res.stats["resumed"] == len(partial)
