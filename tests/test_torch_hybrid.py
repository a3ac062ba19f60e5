"""Mamba2 and the Jamba hybrid through the port's model stack and serving
engine on their smoke configs (float32), reference parameters carried over
by ``params_from_jax``.

* Prefill logits and three teacher-forced decode steps against
  ``repro.models.transformer`` under exact and interp-fused numerics (the
  port's plain versions against the reference's fused backend in interpret
  mode), at a prompt inside one SSD chunk and one of two whole chunks; the
  caches after prefill and after the decodes, layer by layer: positions
  bitwise, K / V and both SSM state leaves within 10x the logit bound.
  Tolerances are ``tests/test_torch_families.py``'s: 2e-5 exact, 4 * 2^-12
  * max|logit| fused, greedy tokens equal wherever the reference's top-2
  gap is clear of the bound.
* The per-kind cache (``MixedCache``): its stacks, ``layer_slots``' index
  into them, and the leaf-by-leaf splice / extract.
* Both engines (the fused tick and the serial oracle) against the
  reference's ``ServeEngine``: streams, stats; serial ≡ fused bitwise on
  exact numerics.
* A journal with two requests in flight resumes to the uninterrupted
  streams, bitwise (the teacher-forced rebuild restores every other slot's
  SSM state after each forced step).
* ``prefill_padded`` and ``mask_cache_tail`` refused; an AOT engine's
  counters equal the reference's (no packed admission); ``submit``'s
  overflow checks; the serve CLI.
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
from repro.configs import base as jbase
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.serve import engine as jengine
from repro_torch.api.library import InterpLibrary
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.faults import Crashed, arm_crashpoint, reset_crashpoints
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.journal import load_requests

ARCHS = ["mamba2_130m", "jamba_v0_1_52b"]
CACHE = 48
SMOKE_TOL = 2e-2  # tests/models/test_smoke.py
# 32 is one whole SSD chunk of the smoke configs
LENGTHS = (5, 32, 3, 11)
MAX_NEW = 6


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
def _libs():
    return default_explorer().compile(), InterpLibrary.default_library("cpu")


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = jbase.get_smoke_config(arch)
    cfg = base.get_smoke_config(arch)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, cfg, jparams, params = _pair(request.param)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params)


def _numerics(name):
    jlib, lib = _libs()
    interp = name != "exact"
    return (jax_get_numerics(name, jlib if interp else None),
            get_numerics(name, lib if interp else None))


def _tol(name, logits):
    return 2e-5 if name == "exact" else 4 * 2.0 ** -12 * np.abs(logits).max()


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=SMOKE_TOL, atol=SMOKE_TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ref = want.reshape(-1, want.shape[-1])
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(
        ref.argmax(-1)[clear], got.reshape(ref.shape).argmax(-1)[clear])


def _layer_leaves(tcache, cfg, i):
    """Layer ``i``'s cache leaves in the port's per-kind stacks."""
    *_, ci, kind = tf.layer_slots(cfg)[i]
    if kind.mixer == "ssm":
        return [t[ci] for t in tcache.ssm]
    return [t[ci] for t in tcache.kv]


def _ref_layer_leaves(jcache, cfg, i):
    """Layer ``i``'s leaves in the reference's per-segment tree."""
    seg, j, r, _ci, _kind = tf.layer_slots(cfg)[i]
    return [np.asarray(t) if r is None else np.asarray(t)[r]
            for t in jcache[seg][j]]


def _assert_cache(tcache, jcache, cfg, tol):
    assert isinstance(tcache, tf.MixedCache)
    for i in range(cfg.n_layers):
        got = _layer_leaves(tcache, cfg, i)
        want = _ref_layer_leaves(jcache, cfg, i)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and str(g.dtype).endswith(
                str(w.dtype))
            if g.dtype == torch.int32:
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=10 * tol)


def _run_both(s, name, toks, steps=3, cache=96, tol_fn=None):
    jcfg, cfg, jparams, params = s["jcfg"], s["cfg"], s["jparams"], s[
        "params"]
    jnum, tnum = _numerics(name)
    jpre = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, numerics=jnum,
                                     cache_len=cache))
    jlog, jcache, _ = jpre(jparams, jnp.asarray(toks))
    tlog, tcache = tf.prefill(params, torch.from_numpy(toks).long(), cfg,
                              tnum, cache)
    tol_fn = tol_fn or functools.partial(_tol, name)
    jlog = np.asarray(jlog)
    tol = tol_fn(jlog)
    _close(tlog.numpy(), jlog, tol)
    _assert_cache(tcache, jcache, cfg, tol)
    jdec = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg,
                                     numerics=jnum))
    b, n = toks.shape
    pos = np.full(b, n, np.int32)
    tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
    for _ in range(steps):
        jlog, jcache = jdec(jparams, jnp.asarray(tok), jnp.asarray(pos),
                            jcache)
        tlog, tcache = tf.decode_step(params, torch.from_numpy(tok).long(),
                                      torch.from_numpy(pos), tcache, cfg,
                                      tnum)
        jlog = np.asarray(jlog)
        _close(tlog.numpy(), jlog, tol_fn(jlog))
        tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1
    _assert_cache(tcache, jcache, cfg, tol)


@pytest.mark.parametrize("n", [13, 64])
@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_prefill_and_decode_match_reference(name, n, setup):
    """Prefill (13 tokens: one partial chunk; 64: two whole chunks) and
    three teacher-forced decodes, logits and caches. Interp-fused at 64
    tokens is held at the reference's smoke tolerance only: each layer
    stays within one table ulp of the reference's fed the same input
    (``test_each_layer_within_a_table_ulp``), but the codes that float32
    reassociation moves compound over the layers and the 64 positions
    (Jamba's logits: 0.007 apart at max|logit| 2.8, past 4 * 2^-12 of it).
    """
    rng = np.random.default_rng(n)
    toks = rng.integers(0, setup["cfg"].vocab_size, (2, n)).astype(np.int32)
    loose = name != "exact" and n > setup["cfg"].ssm.chunk
    _run_both(setup, name, toks,
              tol_fn=(lambda _l: SMOKE_TOL / 2) if loose else None)


def test_each_layer_within_a_table_ulp(setup):
    """The 64-token interp-fused prefill one layer at a time, each layer
    fed the reference's hidden state: the port's layer output within one
    table ulp of the reference's, 4 * 2^-12 * max|h| (a code moved by a
    float32 reassociation upstream of a table read)."""
    jcfg, cfg, jparams, params = (setup[k] for k in ("jcfg", "cfg",
                                                      "jparams", "params"))
    jnum, tnum = _numerics("interp-fused")
    n = 64
    toks = np.random.default_rng(n).integers(0, cfg.vocab_size, (2, n))
    positions = np.broadcast_to(np.arange(n, dtype=np.int32), (2, n))
    jh = jparams["embed"]["tok"][jnp.asarray(toks)]
    pattern = jtf.layer_plan(jcfg)[0].pattern
    for i in range(cfg.n_layers):
        seg, j, r, _ci, kind = tf.layer_slots(cfg)[i]
        jl = jax.tree.map(lambda t, r=r: t if r is None else t[r],
                          jparams["segments"][seg][j])
        jh_next, _, _ = jtf.apply_block(jl, pattern[int(j)], jh,
                                        jnp.asarray(positions), jcfg, jnum,
                                        mode="prefill", cache_len=96)
        h = torch.from_numpy(np.array(jh))
        got = tf.apply_layer(tf.layer_params(params, cfg, i)[1], kind, h,
                             torch.from_numpy(positions.copy()), cfg, tnum,
                             "prefill", cache_len=96)[0]
        want = np.asarray(jh_next)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4 * 2.0 ** -12 * np.abs(want).max(),
                                   err_msg=f"layer {i} ({kind})")
        jh = jh_next


def test_prefill_refuses_a_partial_chunk(setup):
    """A prompt past one chunk that is not a whole number of chunks (40 at
    chunk 32): the reference asserts, the port raises ``ValueError``."""
    toks = np.zeros((1, 40), np.int32)
    jnum, tnum = _numerics("exact")
    with pytest.raises(AssertionError):
        jtf.prefill(setup["jparams"], jnp.asarray(toks), setup["jcfg"], jnum,
                    CACHE)
    with pytest.raises(ValueError, match=r"\(40, 32\)"):
        tf.prefill(setup["params"], torch.from_numpy(toks).long(),
                   setup["cfg"], tnum, CACHE)


def test_mixed_cache_layout_and_row_ops(setup):
    """The per-kind cache: Mamba2 has no K/V stack, Jamba one over its
    attention layers; the SSM stack covers the SSM layers in layer order;
    every leaf has the batch on axis 1. ``splice_cache`` /
    ``extract_cache_row`` / ``splice_cache_rows`` move whole slots, leaf by
    leaf, and ``kv_rows`` reads the K/V rows where there are any."""
    cfg = setup["cfg"]
    kinds = [slot[-1].mixer for slot in tf.layer_slots(cfg)]
    n_ssm = kinds.count("ssm")
    pool = tf.init_cache(cfg, 3, CACHE, device="cpu")
    assert isinstance(pool, tf.MixedCache)
    assert pool.ssm.conv.shape[:2] == pool.ssm.ssm.shape[:2] == (n_ssm, 3)
    assert pool.ssm.ssm.dtype == torch.float32
    assert [slot[3] for slot in tf.layer_slots(cfg)] == [
        kinds[:i].count(k) for i, k in enumerate(kinds)]
    if n_ssm == cfg.n_layers:
        assert pool.kv is None and tf.kv_rows(pool) is None
    else:
        assert pool.kv.k.shape[:2] == (cfg.n_layers - n_ssm, 3)
        assert tf.kv_rows(pool) == CACHE
        assert (pool.kv.pos == -1).all()
    one = tf.init_cache(cfg, 1, CACHE, device="cpu")
    for i, t in enumerate(tf.cache_leaves(one)):
        t.copy_(torch.arange(t.numel()).reshape(t.shape) % 97 + i)
    tf.splice_cache(cfg, pool, one, 2)
    back = tf.extract_cache_row(cfg, pool, torch.tensor(2))
    assert type(back) is type(pool)
    for a, b in zip(tf.cache_leaves(back), tf.cache_leaves(one)):
        assert torch.equal(a, b)
    assert not any(t[:, :2].abs().sum() for t in tf.cache_leaves(pool)
                   if t.dtype != torch.int32)
    tf.splice_cache_rows(cfg, pool, tf.extract_cache_row(cfg, pool, 2),
                         torch.tensor([0]))
    for t in tf.cache_leaves(pool):
        assert torch.equal(t[:, 0], t[:, 2])


def test_prefill_padded_and_tail_mask_refused(setup):
    """Bucketed prefill is refused on both packages (a pad suffix enters
    the cumulative state); the port's tail mask refuses a MixedCache."""
    toks = np.zeros((2, 8), np.int32)
    jnum, tnum = _numerics("exact")
    with pytest.raises(ValueError, match="SSM"):
        jtf.prefill_padded(setup["jparams"], jnp.asarray(toks),
                           jnp.asarray([3, 8]), setup["jcfg"], jnum, CACHE)
    with pytest.raises(ValueError, match="SSM"):
        tf.prefill_padded(setup["params"], torch.from_numpy(toks).long(),
                          [3, 8], setup["cfg"], tnum, CACHE)
    pool = tf.init_cache(setup["cfg"], 2, CACHE, device="cpu")
    with pytest.raises(ValueError, match="SSM"):
        tf.mask_cache_tail(pool, [3, 8])


def _prompts(cfg, lengths=LENGTHS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _serve(mod, cfg, params, slots=2, max_new=MAX_NEW, **kw):
    if mod is tengine:
        kw.setdefault("device", "cpu")
    eng = mod.ServeEngine(cfg, params, slots=slots, cache_len=CACHE, **kw)
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(mod.Request(i, p, max_new=max_new))
    return {r.rid: list(r.out) for r in eng.run()}, eng


@pytest.mark.parametrize("fused", [True, False])
def test_engines_match_reference(fused, setup):
    """Four prompts (one a whole 32-token chunk) over two slots on the
    fused tick and on the serial oracle, exact numerics: streams and the
    reference's counters equal the reference engine's."""
    want, ref = _serve(jengine, setup["jcfg"], setup["jparams"], fused=fused)
    got, eng = _serve(tengine, setup["cfg"], setup["params"], fused=fused)
    assert got == want and set(got) == set(range(len(LENGTHS)))
    assert {k: eng.stats[k] for k in ref.stats} == ref.stats


def test_serial_oracle_equals_fused_tick_bitwise(setup):
    """On exact numerics the serial oracle (one decode forward and a host
    argmax per token) and the fused tick decode the same streams."""
    fused, _ = _serve(tengine, setup["cfg"], setup["params"])
    serial, _ = _serve(tengine, setup["cfg"], setup["params"], fused=False)
    assert fused == serial


@pytest.mark.parametrize("numerics", ["exact", "interp-fused"])
def test_two_in_flight_requests_resume_bitwise(numerics, setup, tmp_path):
    """A journaled run killed after its first tick, with both slots in
    flight mid-stream, resumes to the uninterrupted streams bitwise: the
    second request's rebuild steps the pool, and the first slot's conv
    window and recurrent state are put back after every forced step."""
    cfg = setup["cfg"].replace(numerics=numerics)
    lib = _libs()[1] if numerics != "exact" else None
    want, _ = _serve(tengine,
                     cfg, setup["params"], library=lib, horizon=2)
    jp = tmp_path / "serve.jsonl"
    eng = ServeEngine(cfg, setup["params"], slots=2, cache_len=CACHE,
                      device="cpu", library=lib, horizon=2, journal=str(jp))
    arm_crashpoint("serve.tick.emitted", after=1)
    with pytest.raises(Crashed):
        for i, p in enumerate(_prompts(cfg)):
            eng.submit(Request(i, p, max_new=MAX_NEW))
        eng.run()
    reset_crashpoints()
    pre = load_requests(jp)
    mid = [rid for rid, st in pre.items()
           if st.in_flight and 1 < len(st.out) < st.max_new]
    assert len(mid) == 2, pre
    res = ServeEngine.resume(str(jp), cfg, setup["params"], slots=2,
                             cache_len=CACHE, device="cpu", library=lib,
                             horizon=2)
    res.run()
    final = load_requests(jp)
    assert {rid: st.out for rid, st in final.items()} == want
    assert res.stats["resumed"] == 2 and res.stats["resume_replay_steps"] > 0


def test_aot_engine_counters_equal_reference(setup):
    """``aot_buckets=True`` on an SSM config: no packed admission is
    prepared or used (every prompt takes the exact-length prefill), and
    the AOT counters equal the reference engine's."""
    want, ref = _serve(jengine, setup["jcfg"], setup["jparams"],
                       aot_buckets=True)
    got, eng = _serve(tengine, setup["cfg"],
                      setup["params"], aot_buckets=True)
    assert got == want
    keys = [k for k in ref.stats if k.startswith(("aot_", "packed_"))
            or k == "admit_dispatches"]
    assert keys and {k: eng.stats[k] for k in keys} == {
        k: ref.stats[k] for k in keys}
    assert eng.stats["packed_admits"] == 0 and not eng._packable


def test_submit_keeps_the_overflow_checks(setup):
    """An SSM engine has no window: ``submit`` refuses a prompt past the
    slot cache and a prompt + max_new past it, with the reference's
    reasons (Mamba2 holds no K/V rows, and refuses all the same)."""
    prompt = np.zeros(CACHE + 1, np.int32)
    for mod, cfg, params in ((jengine, setup["jcfg"], setup["jparams"]),
                             (tengine, setup["cfg"], setup["params"])):
        kw = {"device": "cpu"} if mod is tengine else {}
        eng = mod.ServeEngine(cfg, params, slots=1, cache_len=CACHE, **kw)
        for req, reason in ((mod.Request(0, prompt, 2), "prompt_overflow"),
                            (mod.Request(1, prompt[:CACHE], 2),
                             "decode_overflow")):
            with pytest.raises(mod.Rejected) as e:
                eng.submit(req)
            assert e.value.reason == reason
        assert eng.stats["rejected"] == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_serves_through_the_cli(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id> --smoke --device
    cpu``: every request completes."""
    import json

    from repro_torch.launch.serve import main

    main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
          "--max-new", "3", "--cache-len", "48", "--numerics",
          "interp-fused"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tokens"] == 6 and out["failed"] == 0
