"""The decoder families beyond Yi-6B and DeepSeekMoE on their smoke configs
(float32), reference parameters carried over by ``params_from_jax``:
``minicpm3_4b`` (MLA), ``mixtral_8x22b`` (sliding-window MoE),
``qwen1_5_110b`` (QKV bias) and ``minitron_8b`` (squared ReLU), plus the
GELU MLP and tied embeddings on the Yi-6B smoke config.

Prefill logits and three teacher-forced decode steps are held against
``repro.models.transformer`` under exact and interp-fused numerics (the
port's kernels' plain versions against the reference's fused backend in
interpret mode). Tolerance: the reference's own smoke tolerance, rtol =
atol = 2e-2 on logits; in fact the port sits within
``test_torch_model.py``'s much tighter bound (float32 reassociation, 2e-5
exact; one table ulp per moved code, 4 * 2^-12 * max|logit| fused), which
is asserted too, with greedy tokens equal wherever the reference's top-2
gap is clear of it. The caches after prefill and after the decodes: the
positions bitwise (the windowed ring's rotation included), K / V (MLA: the
latent and the rope key) within 10x the logit bound.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch import faults
from repro_torch.api.library import InterpLibrary
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.models.layers import map_tree
from repro_torch.numerics.ops import get_numerics
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["minicpm3_4b", "mixtral_8x22b", "qwen1_5_110b", "minitron_8b"]
CACHE = 48
# the Mixtral prompt passes its 32-token window: a rotated ring (37 % 32)
PROMPT = {"mixtral_8x22b": 37}
SMOKE_TOL = 2e-2  # tests/models/test_smoke.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _libs():
    return default_explorer().compile(), InterpLibrary.default_library("cpu")


def _pair(jcfg, cfg, seed=0):
    jparams = jtf.init_params(jax.random.key(seed), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jparams, params


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jbase.get_smoke_config(request.param)
    cfg = base.get_smoke_config(request.param)
    jparams, params = _pair(jcfg, cfg)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params)


def _numerics(name):
    jlib, lib = _libs()
    interp = name != "exact"
    return (jax_get_numerics(name, jlib if interp else None),
            get_numerics(name, lib if interp else None))


def _tol(name, logits):
    return 2e-5 if name == "exact" else 4 * 2.0 ** -12 * np.abs(logits).max()


def _close(got, want, tol):
    """Within the reference's smoke tolerance and the port's own bound;
    greedy tokens equal where the reference's top-2 gap is clear."""
    np.testing.assert_allclose(got, want, rtol=SMOKE_TOL, atol=SMOKE_TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ref = want.reshape(-1, want.shape[-1])
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(
        ref.argmax(-1)[clear], got.reshape(ref.shape).argmax(-1)[clear])


def _stacked(jcache, jcfg) -> list[np.ndarray]:
    """The reference's per-segment caches as the port's one stack."""
    parts = []
    for i, seg in enumerate(jtf.layer_plan(jcfg)):
        c = jcache[f"seg{i}"]["0"]
        parts.append([np.asarray(t) if seg.repeat > 1 else np.asarray(t)[None]
                      for t in c])
    return [np.concatenate(ts) for ts in zip(*parts)]


def _assert_cache(tcache, jcache, jcfg, tol):
    jk, jv, jpos = _stacked(jcache, jcfg)
    np.testing.assert_array_equal(tcache.pos.numpy(), jpos)
    for got, want in ((tcache.k, jk), (tcache.v, jv)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=10 * tol)


def _run_both(jcfg, cfg, jparams, params, name, toks, cache=CACHE,
              steps=3):
    """Prefill, then ``steps`` decodes teacher-forced with the reference's
    greedy tokens, in both packages; asserts logits and caches."""
    jnum, tnum = _numerics(name)
    jpre = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, numerics=jnum,
                                     cache_len=cache))
    jlog, jcache, _ = jpre(jparams, jnp.asarray(toks))
    tlog, tcache = tf.prefill(params, torch.from_numpy(toks).long(), cfg,
                              tnum, cache)
    jlog = np.asarray(jlog)
    tol = _tol(name, jlog)
    _close(tlog.numpy(), jlog, tol)
    _assert_cache(tcache, jcache, jcfg, tol)
    jdec = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg,
                                     numerics=jnum))
    b, s = toks.shape
    pos = np.full(b, s, np.int32)
    tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
    for _ in range(steps):
        jlog, jcache = jdec(jparams, jnp.asarray(tok), jnp.asarray(pos),
                            jcache)
        tlog, tcache = tf.decode_step(params, torch.from_numpy(tok).long(),
                                      torch.from_numpy(pos), tcache, cfg,
                                      tnum)
        jlog = np.asarray(jlog)
        _close(tlog.numpy(), jlog, _tol(name, jlog))
        tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1
    _assert_cache(tcache, jcache, jcfg, tol)
    return tcache


@pytest.mark.parametrize("arch", ARCHS + ["yi_6b", "deepseek_moe_16b"])
def test_configs_match_reference_figure_for_figure(arch):
    """Every field of the port's config is the reference's, full width and
    smoke; ``sub_quadratic`` agrees; every ported id is a reference id."""
    assert arch in base.ARCH_IDS and set(base.ARCH_IDS) <= set(jbase.ARCH_IDS)
    for get, jget in ((base.get_config, jbase.get_config),
                      (base.get_smoke_config, jbase.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f"{arch}.{f.name}: {got} != {want}"
        assert cfg.sub_quadratic == jcfg.sub_quadratic
        assert cfg.head_size == jcfg.head_size


def test_param_shapes_match_reference(setup):
    """The port's tree for each family is the reference's, leaf for leaf
    (QKV biases, MLA's low-rank and norm leaves, the relu2 MLP's single up
    projection, Mixtral's expert stacks)."""
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                       setup["jparams"])
    got = map_tree(lambda _n, sp: (sp.shape, str(sp.dtype).split(".")[1]),
                   tf.param_shapes(setup["cfg"]))
    assert got == ref
    mixer = setup["params"]["segments"]["seg0"]["0"]["mixer"]
    cfg = setup["cfg"]
    assert ("bq" in mixer) == cfg.attn_bias
    assert ("wkv_b" in mixer) == (cfg.mla is not None)


@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_prefill_and_decode_match_reference(name, setup):
    s = setup
    rng = np.random.default_rng(0)
    n = PROMPT.get(s["cfg"].name, 13)
    toks = rng.integers(0, s["cfg"].vocab_size, (2, n)).astype(np.int32)
    cache = _run_both(s["jcfg"], s["cfg"], s["jparams"], s["params"], name,
                      toks)
    w = s["cfg"].sliding_window
    if w is not None:  # the ring: row r holds the position p % w == r
        live = cache.pos[cache.pos >= 0]
        assert cache.pos.shape[-1] == w and live.numel() == cache.pos.numel()
        assert torch.equal(cache.pos % w, torch.arange(w, dtype=torch.int32)
                           .expand_as(cache.pos))


@pytest.mark.parametrize("variant", [dict(act="gelu"),
                                     dict(tie_embeddings=True)])
def test_gelu_mlp_and_tied_embeddings_match_reference(variant):
    """The GELU MLP (``numerics.gelu``, one up projection) and tied
    embeddings (no ``head`` leaf; logits through ``tok``ᵀ) on the Yi-6B
    smoke config, both numerics."""
    jcfg = jbase.get_smoke_config("yi_6b").replace(**variant)
    cfg = base.get_smoke_config("yi_6b").replace(**variant)
    jparams, params = _pair(jcfg, cfg)
    assert ("head" in params["embed"]) != cfg.tie_embeddings
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    for name in ("exact", "interp-fused"):
        _run_both(jcfg, cfg, jparams, params, name, toks, steps=2)


def test_params_from_jax_refuses_a_leaf_the_port_does_not_name():
    """A reference leaf outside the port's tree raises: the Qwen smoke tree
    with one leaf added, and the same tree against a config without the
    QKV bias (its ``bq`` / ``bk`` / ``bv`` would be dropped silently)."""
    jcfg = jbase.get_smoke_config("qwen1_5_110b")
    cfg = base.get_smoke_config("qwen1_5_110b")
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.key(0), jcfg))
    params_from_jax(tree, cfg, "cpu")  # the tree as it is converts
    mixer = tree["segments"]["seg0"]["0"]["mixer"]
    extra = dict(tree, segments={"seg0": {"0": dict(
        tree["segments"]["seg0"]["0"],
        mixer=dict(mixer, bo=np.zeros(cfg.d_model, np.float32)))}})
    with pytest.raises(KeyError, match="bo"):
        params_from_jax(extra, cfg, "cpu")
    with pytest.raises(KeyError, match="bq"):
        params_from_jax(tree, cfg.replace(attn_bias=False), "cpu")
    with pytest.raises(KeyError, match="no place"):
        params_from_jax(dict(tree, extra={"w": np.zeros(2)}), cfg, "cpu")


def test_mixed_length_pool_decode_matches_reference(setup):
    """Two prompts of different lengths prefilled alone, spliced into a
    3-slot pool, decoded together at per-slot positions (interp-fused)."""
    s = setup
    jnum, tnum = _numerics("interp-fused")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, s["cfg"].vocab_size, n).astype(np.int32)
               for n in (5, 11)]
    slots = (2, 0)
    jpool = jtf.init_cache(s["jcfg"], 3, CACHE)
    tpool = tf.init_cache(s["cfg"], 3, CACHE, device="cpu")
    assert [tuple(t.shape) for t in tpool] == [
        a.shape for a in _stacked(jpool, s["jcfg"])]
    toks, pos = np.zeros((3, 1), np.int32), np.zeros(3, np.int32)
    for prompt, slot in zip(prompts, slots):
        jlog, jc1, _ = jtf.prefill(s["jparams"], jnp.asarray(prompt[None]),
                                   s["jcfg"], jnum, CACHE)
        _, tc1 = tf.prefill(s["params"], torch.from_numpy(prompt[None]).long(),
                            s["cfg"], tnum, CACHE)
        jpool = jtf.splice_cache(s["jcfg"], jpool, jc1, slot)
        tf.splice_cache(s["cfg"], tpool, tc1, slot)
        toks[slot, 0] = int(np.asarray(jlog)[0, -1].argmax())
        pos[slot] = len(prompt)
    jlog, jpool = jtf.decode_step(s["jparams"], jnp.asarray(toks),
                                  jnp.asarray(pos), jpool, s["jcfg"], jnum)
    tlog, tpool = tf.decode_step(s["params"], torch.from_numpy(toks).long(),
                                 torch.from_numpy(pos), tpool, s["cfg"], tnum)
    rows = list(slots)
    jlog = np.asarray(jlog)[rows]
    _close(tlog.numpy()[rows], jlog, _tol("interp-fused", jlog))
    np.testing.assert_array_equal(tpool.pos.numpy(),
                                  _stacked(jpool, s["jcfg"])[2])


def _serve(cfg, params, prompts, slots, max_new=5, **kw):
    eng = ServeEngine(cfg, params, slots=slots, cache_len=CACHE,
                      library=_libs()[1], device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new=max_new))
    return {r.rid: list(r.out) for r in eng.run()}, eng


@pytest.mark.parametrize("fused", [True, False])
def test_mla_mixed_length_batching_matches_one_at_a_time(fused):
    """Twin of the reference's ``test_mixed_length_batching_matches_one_at_
    a_time`` and ``test_fused_mixed_length_batching_matches_solo_oracle``
    on ``minicpm3_4b``: two slots, three prompts of 5 / 11 / 3 tokens; every
    stream bitwise what the same engine serving the request alone gives,
    on the fused tick and on the serial oracle."""
    cfg = base.get_smoke_config("minicpm3_4b").replace(numerics="interp")
    params = tf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 3)]
    done, eng = _serve(cfg, params, prompts, 2, fused=fused)
    assert set(done) == {0, 1, 2}
    assert tuple(eng.caches.k.shape) == (cfg.n_layers, 2, CACHE,
                                         cfg.mla.kv_lora_rank)
    for i, p in enumerate(prompts):
        solo, _ = _serve(cfg, params, [p], 1, fused=fused)
        assert done[i] == solo[0], f"request {i} (len {len(p)}) diverged"


def test_every_family_serves_through_the_cli(capsys):
    """``python -m repro_torch.launch.serve --arch <id> --smoke --device
    cpu`` for each new id: every request completes."""
    import json

    from repro_torch.launch.serve import main

    for arch in ARCHS:
        main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
              "2", "--max-new", "3", "--cache-len", "48",
              "--numerics", "interp-fused"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["tokens"] == 6 and out["failed"] == 0, arch


@pytest.mark.parametrize("arch", ["minicpm3_4b", "mixtral_8x22b"])
def test_fault_ladder_on_mla_and_windowed_engines(arch):
    """The reference's ``test_repeated_nan_ticks_degrade_fused_to_serial``
    on an MLA engine and on a windowed one (prompts past the 32-token
    window, decodes past the wrap): two NaN ticks retire two slots and move
    the engine to the serial rung; the fault log and the reference's
    counters equal the reference engine's, and the finished streams are
    bitwise those of an undisturbed port engine (exact numerics: the
    serial rung decodes what the fused tick does)."""
    jcfg = jbase.get_smoke_config(arch)
    cfg = base.get_smoke_config(arch)
    jparams, params = _pair(jcfg, cfg)
    w = cfg.sliding_window or 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (w + 4, 5, w - 1, 3)]

    def run(mod, flt, c, p, inject=True, **kw):
        eng = mod.ServeEngine(c, p, slots=1, cache_len=64, fused=True,
                              watchdog_limit=2, **kw)
        if inject:
            flt.TickFaultInjector("nan", every_n=1, limit=2).install(eng)
        for i, pr in enumerate(prompts):
            eng.submit(mod.Request(i, pr, max_new=6))
        eng.run()
        return eng

    ref = run(jengine, jfaults, jcfg, jparams)
    port = run(tengine,
               faults, cfg, params, device="cpu")
    assert port.fused is False and port.faults == ref.faults
    assert {k: port.stats[k] for k in ref.stats} == ref.stats
    assert sorted((r.rid, r.error) for r in port.failed) == \
        sorted((r.rid, r.error) for r in ref.failed)
    clean = run(tengine,
                faults, cfg, params, inject=False, device="cpu")
    want = {r.rid: r.out for r in clean.finished}
    assert port.finished and all(r.out == want[r.rid] for r in port.finished)


def test_plain_oracle_slices_reads_and_routes_large_attention(monkeypatch):
    """``PlainFusedNumerics`` (the card run's oracle) reads a large call's
    table codes in slices, bitwise the whole read, and sends attention past
    2^22 (query, key) pairs to the chunked glue path on every device (its
    plain version forms the whole score block)."""
    from repro_torch.numerics import ops

    num = ops.PlainFusedNumerics(_libs()[1])
    x = torch.randn(3, 100, 37, generator=torch.Generator().manual_seed(0))
    whole = num.silu(x)
    monkeypatch.setattr(ops, "PLAIN_SLICE", 1000)
    assert torch.equal(num.silu(x), whole)
    q = torch.zeros(1, 2049, 1, 8)
    pos = torch.arange(2049, dtype=torch.int32)[None]
    assert num.fused_attention(q, q, q, pos, pos, causal=True, window=None,
                               scale=None) is None
    small = num.fused_attention(q[:, :64], q[:, :64], q[:, :64],
                                pos[:, :64], pos[:, :64], causal=True,
                                window=None, scale=None)
    assert small is not None and small.shape == (1, 64, 1, 8)
