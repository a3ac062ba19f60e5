"""The encoder-decoder family (``whisper_tiny``) through the port's model
stack on its smoke config (float32), reference parameters carried over by
``params_from_jax``: LayerNorm, learned positions, the encoder and cross
attention; and the port's ``ARCH_IDS`` against the reference's.

* ``encoder_forward`` against the reference's ``cross`` (the encoder output
  its ``prefill`` returns), then prefill logits and three teacher-forced
  decode steps with ``cross`` under exact and interp-fused numerics (the
  port's plain versions against the reference's fused backend in interpret
  mode); the caches after prefill and after the decodes: positions
  bitwise, K / V within 10x the logit bound.
* LayerNorm against the reference's, and bitwise the same under every
  numerics backend: it reads no table.
* The inputs the reference fails on, refused with ``ValueError``: no
  ``cross`` for an encoder-decoder (the reference: ``AttributeError``), a
  ``cross`` for a config without an encoder (the reference: ``KeyError``),
  and a prompt or cache past the ``max_pos`` learned positions (the
  reference's gather clamps silently).
* The engine's refusal of an encoder-decoder config at construction (the
  reference's engine fails inside ``run()``), and the CLI's exit.
* ``init_params``' rules on both new smoke configs and on the full trees'
  specs.

Tolerances are ``tests/test_torch_families.py``'s: the reference's smoke
tolerance rtol = atol = 2e-2 on logits and the port's own bound (2e-5
exact, 4 * 2^-12 * max|logit| fused), with greedy tokens equal wherever the
reference's top-2 gap is clear of it; the encoder output within the same
bounds taken on its own magnitude.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.serve import engine as jengine
from repro_torch.api.library import InterpLibrary
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.layers import map_tree
from repro_torch.numerics.ops import (ExactNumerics, FusedInterpNumerics,
                                      InterpNumerics, PlainFusedNumerics,
                                      get_numerics)
from repro_torch.serve.engine import ServeEngine

ARCH = "whisper_tiny"
CACHE = 48
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


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jbase.get_smoke_config(ARCH), base.get_smoke_config(ARCH)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal(
        (2, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                frames=frames)


def _numerics(name):
    jlib, lib = _libs()
    interp = name != "exact"
    return (jax_get_numerics(name, jlib if interp else None),
            get_numerics(name, lib if interp else None))


def _tol(name, ref):
    return 2e-5 if name == "exact" else 4 * 2.0 ** -12 * np.abs(ref).max()


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


def _assert_cache(tcache, jcache, tol):
    """The reference's one dense segment (stacked over its layers) against
    the port's one stack."""
    jk, jv, jpos = (np.asarray(t) for t in jcache["seg0"]["0"])
    np.testing.assert_array_equal(tcache.pos.numpy(), jpos)
    for got, want in ((tcache.k, jk), (tcache.v, jv)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=10 * tol)


def test_arch_ids_equal_reference():
    """The port lists the reference's ten ids, in its order."""
    assert base.ARCH_IDS == jbase.ARCH_IDS


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_2b"])
def test_configs_match_reference_figure_for_figure(arch):
    """Every field of the port's config is the reference's, full width and
    smoke (the encoder's too); the two configs have the same fields (the
    training policy ``remat`` among them)."""
    for get, jget in ((base.get_config, jbase.get_config),
                      (base.get_smoke_config, jbase.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f"{arch}.{f.name}: {got} != {want}"
        assert cfg.head_size == jcfg.head_size
        assert cfg.sub_quadratic == jcfg.sub_quadratic
    names = {f.name for f in dataclasses.fields(base.ModelConfig)}
    jnames = {f.name for f in dataclasses.fields(jbase.ModelConfig)}
    assert names == jnames


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_2b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_param_shapes_match_reference(arch, smoke):
    """The port's tree is the reference's ``model_shapes``, leaf for leaf
    (shapes and dtypes, abstract: nothing allocated), at smoke size and at
    full width: ``pos``, ``encoder/{pos, layers, final_norm}``, each norm's
    ``bias``, ``norm_x`` / ``cross`` in every decoder layer, the
    ``projector``."""
    get, jget = ((base.get_smoke_config, jbase.get_smoke_config) if smoke
                 else (base.get_config, jbase.get_config))
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                       jtf.model_shapes(jget(arch)))
    got = map_tree(lambda _n, sp: (sp.shape, str(sp.dtype).split(".")[1]),
                   tf.param_shapes(get(arch)))
    assert got == ref


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_2b"])
def test_init_rules_on_the_full_trees(arch):
    """``init_rule`` on every leaf of the full-width trees' specs (nothing
    allocated): every ``bias`` zero and every norm ``scale`` one, the
    learned ``pos`` table drawn at fan-in 32768, the encoder's at its 1500
    rows, the projector's ``b1`` / ``b2`` drawn at fan-in d (the
    reference's suffix test draws them too)."""
    cfg = base.get_config(arch)
    rules = {}
    map_tree(lambda n, sp: rules.__setitem__(n, tf.init_rule(n, sp.shape)),
             tf.param_shapes(cfg))
    for name, rule in rules.items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "bias":
            assert rule == "zeros", name
        if leaf == "scale":
            assert rule == "ones", name
    if arch == "whisper_tiny":
        assert rules["pos"] == 1 / math.sqrt(32768)
        assert rules["encoder/pos"] == 1 / math.sqrt(1500)
        assert rules["segments/seg0/0/cross/wk"] == 1 / math.sqrt(384)
        # stacked leaves: norm1 / norm_x / norm2 of the decoder, norm1 /
        # norm2 of the encoder, the two final norms
        assert sum(n.endswith("/bias") for n in rules) == 3 + 2 + 2
    else:
        assert rules["projector/b1"] == rules["projector/b2"] == \
            1 / math.sqrt(2048)
        assert rules["projector/norm/bias"] == "zeros"
        assert rules["projector/w1"] == 1 / math.sqrt(1024)


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_2b"])
def test_init_params_rules_on_the_smoke_configs(arch):
    """``init_params`` on the smoke configs: biases zero, LayerNorm scales
    one, ``pos`` a truncated normal of std 1/sqrt(32768) (the draw's own
    std is 0.8796 of that), the projector's ``b1`` / ``b2`` drawn."""
    cfg = base.get_smoke_config(arch)
    params = tf.init_params(cfg, seed=0, device="cpu")
    seen = []

    def check(name, t):
        leaf = name.rsplit("/", 1)[-1]
        if leaf == "bias":
            assert not t.any(), name
        if leaf == "scale":
            assert bool((t == 1).all()), name
        seen.append(name)
    map_tree(check, params)
    if arch == "whisper_tiny":
        assert "segments/seg0/0/norm_x/bias" in seen
        std = float(params["pos"].std()) * math.sqrt(32768)
        assert abs(std / 0.8796 - 1) < 0.02, std
    else:
        pr = params["projector"]
        for b in ("b1", "b2"):
            assert bool(pr[b].abs().gt(0).all()), b
            std = float(pr[b].std()) * math.sqrt(cfg.d_model)
            assert 0.5 < std < 1.2, (b, std)


def test_layernorm_matches_reference_and_reads_no_table():
    """``apply_norm`` under ``norm="layernorm"``: within float32 rounding
    of the reference's, and bitwise the same under exact, interp,
    interp-fused (the plain versions on the CPU) and the card oracle's
    backend; a backend whose every attribute raises is never touched."""
    cfg = base.get_smoke_config(ARCH)
    jcfg = jbase.get_smoke_config(ARCH)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, cfg.d_model)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    want = np.asarray(jlayers.apply_norm(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        jax_get_numerics("exact")))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    lib = _libs()[1]

    class NoTable:
        def __getattr__(self, name):
            raise AssertionError(f"LayerNorm read numerics.{name}")

    outs = [layers.apply_norm(tp, torch.from_numpy(x), cfg, num)
            for num in (ExactNumerics(), InterpNumerics(lib),
                        FusedInterpNumerics(lib), PlainFusedNumerics(lib),
                        NoTable())]
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=0, atol=2e-6)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    # bf16 activations in, bf16 out, the statistics in float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.apply_norm(tp, xb, cfg, NoTable())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, layers.layer_norm(xb.float(), tp["scale"],
                                              tp["bias"]).to(torch.bfloat16))


@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_encoder_forward_matches_reference(name, setup):
    """The encoder over (2, 64, 64) float32 frames against the ``cross``
    that the reference's ``prefill`` returns for the same frames."""
    s = setup
    jnum, tnum = _numerics(name)
    toks = jnp.zeros((2, 1), jnp.int32)
    _, _, jcross = jtf.prefill(s["jparams"], toks, s["jcfg"], jnum, CACHE,
                               enc_frames=jnp.asarray(s["frames"]))
    want = np.asarray(jcross)
    got = tf.encoder_forward(s["params"]["encoder"],
                             torch.from_numpy(s["frames"]), s["cfg"], tnum)
    assert tuple(got.shape) == want.shape == (2, 64, 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=SMOKE_TOL,
                               atol=SMOKE_TOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_tol(name, want))


@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_prefill_and_decode_with_cross_match_reference(name, setup):
    """Prefill of a 13-token prompt with the encoder output, then three
    decodes teacher-forced with the reference's greedy tokens, each with
    ``cross``: logits and caches against the reference's."""
    s = setup
    jnum, tnum = _numerics(name)
    toks = np.random.default_rng(1).integers(
        0, s["cfg"].vocab_size, (2, 13)).astype(np.int32)
    jpre = jax.jit(functools.partial(jtf.prefill, cfg=s["jcfg"],
                                     numerics=jnum, cache_len=CACHE))
    jlog, jcache, jcross = jpre(s["jparams"], jnp.asarray(toks),
                                enc_frames=jnp.asarray(s["frames"]))
    cross = tf.encoder_forward(s["params"]["encoder"],
                               torch.from_numpy(s["frames"]), s["cfg"], tnum)
    tlog, tcache = tf.prefill(s["params"], torch.from_numpy(toks).long(),
                              s["cfg"], tnum, CACHE, cross=cross)
    jlog = np.asarray(jlog)
    tol = _tol(name, jlog)
    _close(tlog.numpy(), jlog, tol)
    _assert_cache(tcache, jcache, tol)
    jdec = jax.jit(functools.partial(jtf.decode_step, cfg=s["jcfg"],
                                     numerics=jnum))
    pos = np.full(2, 13, np.int32)
    tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jlog, jcache = jdec(s["jparams"], jnp.asarray(tok), jnp.asarray(pos),
                            jcache, cross=jcross)
        tlog, tcache = tf.decode_step(s["params"],
                                      torch.from_numpy(tok).long(),
                                      torch.from_numpy(pos), tcache,
                                      s["cfg"], tnum, cross=cross)
        jlog = np.asarray(jlog)
        _close(tlog.numpy(), jlog, _tol(name, jlog))
        tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1
    _assert_cache(tcache, jcache, tol)


def test_cross_attention_reads_every_encoder_row(setup):
    """Cross attention is non-causal with every position 0: a change to the
    encoder's last row moves the decoder's first-position logits."""
    s = setup
    num = get_numerics("exact")
    toks = torch.zeros((1, 1), dtype=torch.int64)
    cross = tf.encoder_forward(s["params"]["encoder"],
                               torch.from_numpy(s["frames"][:1]), s["cfg"],
                               num)
    base_log, _ = tf.prefill(s["params"], toks, s["cfg"], num, CACHE,
                             cross=cross)
    moved = cross.clone()
    moved[:, -1] += 1.0
    log, _ = tf.prefill(s["params"], toks, s["cfg"], num, CACHE, cross=moved)
    assert not torch.allclose(log, base_log)


def test_inputs_the_reference_fails_on_are_refused(setup):
    """Each refusal at the input where the reference fails: an
    encoder-decoder prefill or decode without ``cross`` (the reference's
    prefill without frames raises ``AttributeError``), a ``cross`` for a
    config without an encoder (the reference's decode raises
    ``KeyError``), and under learned positions a prompt or cache past
    ``max_pos`` (the reference's gather clamps and runs on)."""
    s = setup
    jnum, num = _numerics("exact")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(AttributeError):
        jtf.prefill(s["jparams"], jnp.asarray(toks), s["jcfg"], jnum, CACHE)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tf.prefill(s["params"], torch.from_numpy(toks).long(), s["cfg"], num,
                   CACHE)
    cross = tf.encoder_forward(s["params"]["encoder"],
                               torch.from_numpy(s["frames"][:1]), s["cfg"],
                               num)
    _, cache = tf.prefill(s["params"], torch.from_numpy(toks).long(),
                          s["cfg"], num, CACHE, cross=cross)
    one = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tf.decode_step(s["params"], one, 4, cache, s["cfg"], num)

    # a cross for a decoder-only config
    ycfg, jycfg = (base.get_smoke_config("yi_6b"),
                   jbase.get_smoke_config("yi_6b"))
    jyp = jtf.init_params(jax.random.key(0), jycfg)
    yp = params_from_jax(jax.tree.map(np.asarray, jyp), ycfg, "cpu")
    _, jyc, _ = jtf.prefill(jyp, jnp.asarray(toks), jycfg, jnum, CACHE)
    with pytest.raises(KeyError):
        jtf.decode_step(jyp, jnp.zeros((1, 1), jnp.int32), jnp.int32(4), jyc,
                        jycfg, jnum, cross=jnp.asarray(cross.numpy()))
    _, yc = tf.prefill(yp, torch.from_numpy(toks).long(), ycfg, num, CACHE)
    with pytest.raises(ValueError, match="no encoder"):
        tf.decode_step(yp, one, 4, yc, ycfg, num, cross=cross)
    with pytest.raises(ValueError, match="no encoder"):
        tf.prefill(yp, torch.from_numpy(toks).long(), ycfg, num, CACHE,
                   cross=cross)

    # past the learned positions: a 3-row table, a 4-token prompt
    short, jshort = (s["cfg"].replace(max_pos=3),
                     s["jcfg"].replace(max_pos=3))
    jsp = dict(s["jparams"], pos=s["jparams"]["pos"][:3])
    sp = dict(s["params"], pos=s["params"]["pos"][:3])
    jlog, _, _ = jtf.prefill(jsp, jnp.asarray(toks), jshort, jnum, 8,
                             enc_frames=jnp.asarray(s["frames"][:1]))
    assert np.isfinite(np.asarray(jlog)).all()  # clamped, silently
    with pytest.raises(ValueError, match="prompt length 4 exceeds"):
        tf.prefill(sp, torch.from_numpy(toks).long(), short, num, 8,
                   cross=cross)
    with pytest.raises(ValueError, match="cache_len 8 exceeds"):
        tf.prefill(sp, torch.from_numpy(toks[:, :2]).long(), short, num, 8,
                   cross=cross)
    with pytest.raises(ValueError, match="cache_len 48 exceeds"):
        tf.decode_step(sp, one, 2, cache, short, num, cross=cross)


def test_engine_refuses_an_encoder_decoder(setup):
    """The port's engine refuses ``whisper_tiny`` at construction, saying
    why; the reference's takes it and fails inside ``run()``, where its
    prefill meets no frames."""
    s = setup
    ref = jengine.ServeEngine(s["jcfg"], s["jparams"], slots=1,
                              cache_len=CACHE)
    ref.submit(jengine.Request(0, np.zeros(4, np.int32), max_new=2))
    with pytest.raises(AttributeError):
        ref.run()
    with pytest.raises(ValueError, match="carries no encoder frames"):
        ServeEngine(s["cfg"], s["params"], slots=1, cache_len=CACHE,
                    device="cpu")


def test_cli_exits_with_the_refusal(capsys):
    """``--arch whisper_tiny`` exits with code 2 and the engine's message,
    no traceback."""
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit) as e:
        main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "carries no encoder frames" in err and "Traceback" not in err
