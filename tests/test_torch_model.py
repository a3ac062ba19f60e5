"""The decoder on the ``yi_6b`` (dense) and ``deepseek_moe_16b`` (a dense
layer 0, then MoE layers) smoke configs (float32), reference parameters
carried over by ``params_from_jax``: prefill and decode logits against
``repro.models.transformer`` under exact and interp-fused numerics. The
reference keeps one KV cache per segment; the port one stacked cache over
all layers, compared by concatenating the reference's along the layer axis.

Tolerances: exact numerics differ by float32 reassociation (matmul and
reduction order) through two layers: atol 2e-5 on logits of scale ~3.
Interp-fused numerics may in addition move a table code across a boundary
where a reassociated float lands next to it; one flip changes one rsqrt,
recip or silu value by one table ulp (<= 2^-12 relative), so the stated
bound is 4 * 2^-12 * max|logit|. Greedy tokens must match wherever the
reference's top-2 logit gap exceeds that tolerance. For the MoE config the
same tolerances hold as long as every token routes to the same experts in
both packages (the router's top-k gaps on these inputs are far wider than
the probabilities' differences; ``test_torch_moe.py`` holds routing
tie-aware).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import map_tree
from repro_torch.numerics.ops import get_numerics

CACHE = 32
ARCHS = ["yi_6b", "deepseek_moe_16b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jlib=default_explorer().compile(),
                lib=InterpLibrary.default_library("cpu"))


def _numerics(s, name):
    interp = name != "exact"
    return (jax_get_numerics(name, s["jlib"] if interp else None),
            get_numerics(name, s["lib"] if interp else None))


def _tol(name, logits):
    return 2e-5 if name == "exact" else 4 * 2.0 ** -12 * np.abs(logits).max()


def _assert_greedy(ref_logits, got_logits, tol):
    ref = ref_logits.reshape(-1, ref_logits.shape[-1])
    got = got_logits.reshape(-1, got_logits.shape[-1])
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(ref.argmax(-1)[clear], got.argmax(-1)[clear])


def _stacked_cache(jcache, jcfg) -> list[np.ndarray]:
    """The reference's per-segment caches as the port's one (k, v, pos)
    stack: unstacked one-layer segments get a layer axis, then all are
    concatenated along it."""
    parts = []
    for i, seg in enumerate(jtf.layer_plan(jcfg)):
        c = jcache[f"seg{i}"]["0"]
        parts.append([np.asarray(t) if seg.repeat > 1 else np.asarray(t)[None]
                      for t in c])
    return [np.concatenate(ts) for ts in zip(*parts)]


def _segment_cache(cache: KVCache, jcfg, like) -> dict:
    """The port's stacked cache cut into the reference's per-segment
    layout (``like``: a reference cache tree of that layout)."""
    out, at = {}, 0
    for i, seg in enumerate(jtf.layer_plan(jcfg)):
        ts = [jnp.asarray(t.numpy()[at:at + seg.repeat]) for t in cache]
        if seg.repeat == 1:
            ts = [t[0] for t in ts]
        out[f"seg{i}"] = {"0": type(like[f"seg{i}"]["0"])(*ts)}
        at += seg.repeat
    return out


def test_params_from_jax_layout(setup):
    p, cfg, jp = setup["params"], setup["cfg"], setup["jparams"]
    plan = tf.layer_plan(cfg)
    assert len(plan) == len(jtf.layer_plan(setup["jcfg"]))
    for i, seg in enumerate(plan):
        layer = p["segments"][f"seg{i}"]["0"]
        lead = (seg.repeat,) if seg.repeat > 1 else ()
        assert tuple(layer["mixer"]["wq"].shape) == lead + (
            cfg.d_model, cfg.n_heads * cfg.head_size)
        ffn = layer["ffn"]
        if seg.pattern[0].ffn == "moe":
            m = cfg.moe
            assert tuple(ffn["wi"].shape) == lead + (
                m.n_experts, cfg.d_model, 2 * m.d_expert)
            assert ffn["router"].dtype == torch.float32
        else:
            assert tuple(ffn["wi"].shape) == lead + (
                cfg.d_model, 2 * seg.pattern[0].mlp_ff)
    np.testing.assert_array_equal(
        p["embed"]["head"].numpy(), np.asarray(jp["embed"]["head"]))
    # every leaf keeps the reference's dtype; a leaf cast to another dtype
    # than its own or the parameter dtype (which an optimizer step writes
    # every leaf back in: a trained state's router is bf16) is refused
    if cfg.family == "moe":
        bf = cfg.replace(param_dtype="bfloat16")
        jbf = jtf.init_params(jax.random.key(1),
                              setup["jcfg"].replace(param_dtype="bfloat16"))
        tree = jax.tree.map(np.asarray, jbf)
        got = params_from_jax(tree, bf, "cpu")
        assert got["segments"]["seg1"]["0"]["ffn"]["router"].dtype == \
            torch.float32
        assert got["segments"]["seg1"]["0"]["ffn"]["wi"].dtype == \
            torch.bfloat16
        router = tree["segments"]["seg1"]["0"]["ffn"]
        f32 = router["router"]
        router["router"] = np.asarray(jnp.asarray(f32).astype(jnp.bfloat16))
        got = params_from_jax(tree, bf, "cpu")
        assert got["segments"]["seg1"]["0"]["ffn"]["router"].dtype == \
            torch.bfloat16
        router["router"] = f32.astype(np.float16)
        with pytest.raises(TypeError, match="router"):
            params_from_jax(tree, bf, "cpu")
        router["router"] = f32
        router["wi"] = np.asarray(router["wi"]).astype(np.float32)
        with pytest.raises(TypeError, match="wi"):
            params_from_jax(tree, bf, "cpu")


@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_prefill_and_decode_logits_match_reference(name, setup):
    s = setup
    jnum, tnum = _numerics(s, name)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, s["cfg"].vocab_size, (2, 13)).astype(np.int32)
    jpre = jax.jit(functools.partial(jtf.prefill, cfg=s["jcfg"],
                                     numerics=jnum, cache_len=CACHE))
    jlog, jcache, _ = jpre(s["jparams"], jnp.asarray(toks))
    tlog, tcache = tf.prefill(s["params"], torch.from_numpy(toks).long(),
                              s["cfg"], tnum, CACHE)
    jlog = np.asarray(jlog)
    tol = _tol(name, jlog)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0, atol=tol)
    _assert_greedy(jlog, tlog.numpy(), tol)
    jk, _, jpos = _stacked_cache(jcache, s["jcfg"])
    np.testing.assert_array_equal(tcache.pos.numpy(), jpos)
    np.testing.assert_allclose(tcache.k.numpy(), jk, rtol=0, atol=10 * tol)

    jdec = jax.jit(functools.partial(jtf.decode_step, cfg=s["jcfg"],
                                     numerics=jnum))
    pos = np.array([13, 13], np.int32)
    tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):  # teacher-forced with the reference's tokens
        jlog2, jcache = jdec(s["jparams"], jnp.asarray(tok), jnp.asarray(pos),
                             jcache)
        tlog2, tcache = tf.decode_step(s["params"],
                                       torch.from_numpy(tok).long(),
                                       torch.from_numpy(pos), tcache,
                                       s["cfg"], tnum)
        jlog2 = np.asarray(jlog2)
        np.testing.assert_allclose(tlog2.numpy(), jlog2, rtol=0,
                                   atol=_tol(name, jlog2))
        tok = jlog2[:, 0].argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1
    np.testing.assert_array_equal(tcache.pos.numpy(),
                                  _stacked_cache(jcache, s["jcfg"])[2])


def _bf16_params(arch):
    """The smoke configs of ``arch`` and reference parameters in bfloat16,
    with every norm scale drawn off 1 (bf16-exact values in [0.5, 1.5)) so
    that the scale's dtype matters; the port's parameters carried over."""
    jcfg = jax_smoke_config(arch).replace(param_dtype="bfloat16")
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16")
    rng = np.random.default_rng(5)

    def scales(tree):
        return {k: scales(v) if isinstance(v, dict) else
                ((1 + rng.integers(-64, 64, v.shape) / 128).astype(v.dtype)
                 if k == "scale" else v) for k, v in tree.items()}

    tree = scales(jax.tree.map(np.asarray,
                               jtf.init_params(jax.random.key(0), jcfg)))
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg, "cpu"))


def _port_logits(params, cfg, numerics, toks, feed):
    """Prefill logits, then one decode step's per (token, position) of
    ``feed``."""
    log, cache = tf.prefill(params, torch.from_numpy(toks).long(), cfg,
                            numerics, CACHE)
    out = [log]
    for tok, pos in feed:
        log, cache = tf.decode_step(params, torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos), cache, cfg,
                                    numerics)
        out.append(log)
    return out


def _cast_norm(p, x, cfg, numerics):
    """``apply_norm`` as it was: the scale cast to float32 first."""
    return numerics.rmsnorm(x, p["scale"].to(torch.float32)).to(x.dtype)


def test_bf16_norm_scale_as_stored_matches_the_cast(setup, monkeypatch):
    """bfloat16 parameters under interp-fused numerics: prefill and decode
    logits with the norm scale passed as stored are bitwise those with the
    scale cast to float32 first (the expression before)."""
    _, cfg, _, params = _bf16_params(setup["cfg"].name)
    tnum = _numerics(setup, "interp-fused")[1]
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    feed = [(np.array([[3], [7]], np.int32) + i, np.array([13, 13], np.int32)
             + i) for i in range(3)]
    now = _port_logits(params, cfg, tnum, toks, feed)
    monkeypatch.setattr(tf, "apply_norm", _cast_norm)
    before = _port_logits(params, cfg, tnum, toks, feed)
    for a, b in zip(now, before):
        assert a.dtype == torch.bfloat16
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_bf16_params_logits_match_reference():
    """The same bfloat16 parameters on the dense decoder against the
    reference, as ``test_prefill_and_decode_logits_match_reference`` holds
    float32 ones (its tolerance, tie-aware greedy tokens, decode
    teacher-forced with the reference's tokens). The other nine families,
    the MoE ones among them, are held in bf16 by
    ``tests/test_torch_bf16_*.py``, with a test-side shim for the
    reference's float32-preferred einsums, which XLA's CPU backend cannot
    run on bf16 operands (its DotThunk has no bf16 x bf16 -> f32 dot)."""
    jcfg, cfg, jparams, params = _bf16_params("yi_6b")
    jnum = jax_get_numerics("interp-fused", default_explorer().compile())
    tnum = get_numerics("interp-fused", InterpLibrary.default_library("cpu"))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    jpre = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, numerics=jnum,
                                     cache_len=CACHE))
    jdec = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg,
                                     numerics=jnum))
    jlog, jcache, _ = jpre(jparams, jnp.asarray(toks))
    ref, feed = [np.asarray(jlog).astype(np.float32)], []
    pos = np.array([13, 13], np.int32)
    for _ in range(3):
        tok = ref[-1][:, 0].argmax(-1)[:, None].astype(np.int32)
        feed.append((tok, pos))
        jlog, jcache = jdec(jparams, jnp.asarray(tok), jnp.asarray(pos),
                            jcache)
        ref.append(np.asarray(jlog).astype(np.float32))
        pos = pos + 1
    for got, want in zip(_port_logits(params, cfg, tnum, toks, feed), ref):
        got = got.float().numpy()
        tol = _tol("interp-fused", want)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        _assert_greedy(want, got, tol)


def test_mixed_length_pool_decode_matches_reference(setup):
    """Two prompts of different lengths prefilled alone, spliced into a
    3-slot pool, decoded together at per-slot positions."""
    s = setup
    jnum, tnum = _numerics(s, "interp-fused")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 11)]
    slots = (2, 0)
    jpool = jtf.init_cache(s["jcfg"], 3, CACHE)
    tpool = tf.init_cache(s["cfg"], 3, CACHE, device="cpu")
    toks, pos = np.zeros((3, 1), np.int32), np.zeros(3, np.int32)
    jpre = jax.jit(functools.partial(jtf.prefill, cfg=s["jcfg"],
                                     numerics=jnum, cache_len=CACHE))
    for prompt, slot in zip(prompts, slots):
        jlog, jc1, _ = jpre(s["jparams"], jnp.asarray(prompt[None]))
        _, tc1 = tf.prefill(s["params"], torch.from_numpy(prompt[None]).long(),
                            s["cfg"], tnum, CACHE)
        jpool = jtf.splice_cache(s["jcfg"], jpool, jc1, slot)
        tf.splice_cache(s["cfg"], tpool, tc1, slot)
        toks[slot, 0] = int(np.asarray(jlog)[0, -1].argmax())
        pos[slot] = len(prompt)
    jdec = jax.jit(functools.partial(jtf.decode_step, cfg=s["jcfg"],
                                     numerics=jnum))
    jlog, _ = jdec(s["jparams"], jnp.asarray(toks), jnp.asarray(pos), jpool)
    tlog, _ = tf.decode_step(s["params"], torch.from_numpy(toks).long(),
                             torch.from_numpy(pos), tpool, s["cfg"], tnum)
    jlog = np.asarray(jlog)
    tol = _tol("interp-fused", jlog[list(slots)])
    np.testing.assert_allclose(tlog.numpy()[list(slots)], jlog[list(slots)],
                               rtol=0, atol=tol)
    _assert_greedy(jlog[list(slots)], tlog.numpy()[list(slots)], tol)


def test_splice_cache_writes_the_slot_axis(setup):
    """The one-request cache lands in batch slot 2 of a (L, B, ...) pool,
    not in layer 2 (the layer-axis splice once corrupted row 0)."""
    cfg = setup["cfg"]
    pool = tf.init_cache(cfg, 3, 8, device="cpu")
    one = tf.init_cache(cfg, 1, 8, device="cpu")
    g = torch.Generator().manual_seed(0)
    for t in (one.k, one.v):
        t.copy_(torch.randn(t.shape, generator=g))
    one.pos.copy_(torch.arange(8, dtype=torch.int32))
    tf.splice_cache(cfg, pool, one, 2)
    for dst, src in zip(pool, one):
        assert torch.equal(dst[:, 2], src[:, 0])
    assert (pool.k[:, :2] == 0).all() and (pool.pos[:, :2] == -1).all()
    # the reference's splice on the same data gives the same pool
    jpool = jtf.init_cache(setup["jcfg"], 3, 8)
    jone = _segment_cache(one, setup["jcfg"], jpool)
    jpool = jtf.splice_cache(setup["jcfg"], jpool, jone, 2)
    for a, b in zip(pool, _stacked_cache(jpool, setup["jcfg"])):
        np.testing.assert_array_equal(a.numpy(), b)


def test_init_params_shapes_and_rules(setup, monkeypatch):
    """Shapes and dtypes of the reference's tree; unit norm scales;
    truncated-normal fan-in init; seeded; and every leaf of rank >= 3
    (stacked layers, the MoE expert stacks) drawn one leading-axis slice
    at a time, which at full width keeps each float32 draw within one
    layer (<= 1.5 GB)."""
    cfg = setup["cfg"]
    draws = []
    real = torch.nn.init.trunc_normal_

    def spy(t, *a, **kw):
        draws.append(tuple(t.shape))
        return real(t, *a, **kw)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", spy)
    p = tf.init_params(cfg, seed=3, device="cpu")
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                       setup["jparams"])
    got = map_tree(lambda _n, t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                   p)
    assert got == ref
    shapes = tf.param_shapes(cfg)
    want_draws = []
    map_tree(lambda n, sp: None if n.endswith("scale") else want_draws.extend(
        [sp.shape[1:]] * sp.shape[0] if len(sp.shape) >= 3 else [sp.shape]),
             shapes)
    assert draws == want_draws
    if cfg.family == "moe":
        assert (cfg.moe.n_experts, cfg.d_model, 2 * cfg.moe.d_expert) in draws
    full = tf.param_shapes(get_config(cfg.name))
    peak = []
    map_tree(lambda n, sp: peak.append(4 * math.prod(
        sp.shape[1:] if len(sp.shape) >= 3 else sp.shape)), full)
    assert max(peak) <= 1.5e9
    for i in range(cfg.n_layers):
        _, lp = tf.layer_params(p, cfg, i)
        assert torch.equal(lp["norm1"]["scale"], torch.ones(cfg.d_model))
    wq = torch.cat([tf.layer_params(p, cfg, i)[1]["mixer"]["wq"].flatten()
                    for i in range(cfg.n_layers)])
    assert wq.abs().max() <= 2.0 / cfg.d_model ** 0.5
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 0.88) < 0.1
    again = tf.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(again["embed"]["tok"], p["embed"]["tok"])
