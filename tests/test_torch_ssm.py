"""The Mamba2 mixer (``repro_torch.models.ssm``) against the reference's
``repro.models.ssm`` on the CPU, the two SSM configs figure for figure,
their parameter trees and the port's init rules.

Inputs are numpy from a seed; the interp-fused runs hold the port's plain
versions against the reference's fused backend in interpret mode.
Tolerances (``tests/test_torch_families.py``'s): float32 reassociation,
2e-5 times the reference's largest magnitude on the exact path; one table
ulp per moved code, 4 * 2^-12 times it on the interp-fused path (the two
packages' cumulative sums differ in the last bits, which can move a
quantized exp_neg code).

The SSD contract: a sequence longer than one chunk must be a whole number
of chunks. The reference asserts it; the port raises ``ValueError`` at
exactly the same lengths.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro_torch.api.library import InterpLibrary
from repro_torch.configs import base
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.layers import map_tree
from repro_torch.numerics.ops import get_numerics

ARCHS = ["mamba2_130m", "jamba_v0_1_52b"]
NAMES = ["exact", "interp-fused"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _libs():
    return default_explorer().compile(), InterpLibrary.default_library("cpu")


def _numerics(name):
    jlib, lib = _libs()
    interp = name != "exact"
    return (jax_get_numerics(name, jlib if interp else None),
            get_numerics(name, lib if interp else None))


def _tol(name, ref) -> float:
    scale = max(1.0, float(np.abs(ref).max()))
    return (2e-5 if name == "exact" else 4 * 2.0 ** -12) * scale


def _close(got: torch.Tensor, want, name, tol=None):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol or _tol(name, want))


def _mixer_params(arch, seed=0):
    """One SSM layer's parameters, the reference's tree and the port's."""
    jcfg = jbase.get_smoke_config(arch)
    cfg = base.get_smoke_config(arch)
    shapes = jssm.ssm_shapes(jcfg)
    jp = jlayers.init_tree(jax.random.key(seed), shapes)
    # a random dt_bias and d_skip, so that neither enters as a constant
    rng = np.random.default_rng(seed)
    h = shapes["a_log"].shape[0]
    jp = dict(jp, dt_bias=jnp.asarray(rng.normal(0, 0.5, h), jnp.float32),
              d_skip=jnp.asarray(rng.uniform(0.5, 1.5, h), jnp.float32))
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert map_tree(lambda _n, t: (tuple(t.shape), t.dtype), p) == map_tree(
        lambda _n, sp: sp, ssm.ssm_shapes(cfg))
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_figure_for_figure(arch):
    """Every field of the port's config is the reference's (the nested
    ``SSMConfig`` and ``MoEConfig`` too), full width and smoke; the family
    is sub-quadratic in both."""
    assert arch in base.ARCH_IDS and set(base.ARCH_IDS) <= set(jbase.ARCH_IDS)
    for get, jget in ((base.get_config, jbase.get_config),
                      (base.get_smoke_config, jbase.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(got):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, f"{arch}.{f.name}: {got} != {want}"
        assert cfg.sub_quadratic and jcfg.sub_quadratic


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference(arch, smoke):
    """The port's tree is the reference's ``model_shapes``, leaf for leaf
    (shapes and dtypes; specs only, nothing allocated): Mamba2's FFN-less
    layers, Jamba's period of 7 SSM layers and one attention layer with
    MoE on the odd ones, stacked where the period repeats."""
    get, jget = ((base.get_smoke_config, jbase.get_smoke_config) if smoke
                 else (base.get_config, jbase.get_config))
    cfg, jcfg = get(arch), jget(arch)
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                       jtf.model_shapes(jcfg))
    got = map_tree(lambda _n, sp: (sp.shape, str(sp.dtype).split(".")[1]),
                   tf.param_shapes(cfg))
    assert got == ref
    assert [dataclasses.astuple(k) for seg in tf.layer_plan(cfg)
            for k in seg.pattern] == [
        dataclasses.astuple(k) for seg in jtf.layer_plan(jcfg)
        for k in seg.pattern]


def test_hybrid_plan_refuses_a_partial_period():
    """``n_layers`` not a whole number of ``attn_period`` layers: the
    reference asserts, the port raises ``ValueError``."""
    cfg = base.get_smoke_config("jamba_v0_1_52b").replace(n_layers=6)
    with pytest.raises(AssertionError):
        jtf.layer_plan(jbase.get_smoke_config("jamba_v0_1_52b").replace(
            n_layers=6))
    with pytest.raises(ValueError, match="period"):
        tf.layer_plan(cfg)


def _ssd_inputs(cfg, seq, seed):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h = d_inner // s.head_dim
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(0, 1, (2, seq, h, s.head_dim)).astype(f),
        dt=rng.uniform(0.01, 0.6, (2, seq, h)).astype(f),
        a=(-np.arange(1, h + 1)).astype(f),
        b_mat=rng.normal(0, 0.5, (2, seq, s.n_groups, s.d_state)).astype(f),
        c_mat=rng.normal(0, 0.5, (2, seq, s.n_groups, s.d_state)).astype(f),
        d_skip=rng.uniform(0.5, 1.5, h).astype(f),
        h0=rng.normal(0, 1, (2, h, s.head_dim, s.d_state)).astype(f))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_ssd_chunked_matches_reference(n_chunks, with_h0, name):
    """``ssd_chunked`` at 1, 2 and 3 whole chunks of the smoke chunk (32),
    from zero state and from a given ``h0``: y and the final state."""
    jcfg = jbase.get_smoke_config("mamba2_130m")
    cfg = base.get_smoke_config("mamba2_130m")
    inp = _ssd_inputs(cfg, n_chunks * cfg.ssm.chunk, seed=n_chunks)
    h0 = inp.pop("h0") if with_h0 else None
    inp.pop("h0", None)
    jnum, tnum = _numerics(name)
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(v) for v in inp.values()), jcfg,
                              jnum, None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.ssd_chunked(*(torch.from_numpy(v) for v in inp.values()),
                             cfg, tnum,
                             None if h0 is None else torch.from_numpy(h0))
    _close(ty, jy, name)
    _close(th, jh, name)


@pytest.mark.parametrize("seq,ok", [(32, True), (31, True), (17, True),
                                    (1, True), (64, True), (96, True),
                                    (40, False), (33, False), (63, False),
                                    (100, False)])
def test_ssd_whole_chunk_contract(seq, ok):
    """Below one chunk any length runs (the chunk is the sequence); past
    it only whole chunks: the reference's ``AssertionError (seq, chunk)``
    is the port's ``ValueError`` at the same lengths, with the same
    figures in the message."""
    jcfg = jbase.get_smoke_config("mamba2_130m")
    cfg = base.get_smoke_config("mamba2_130m")
    inp = _ssd_inputs(cfg, seq, seed=seq)
    inp.pop("h0")
    jnum, tnum = _numerics("exact")
    jargs = [jnp.asarray(v) for v in inp.values()]
    targs = [torch.from_numpy(v) for v in inp.values()]
    if ok:
        jssm.ssd_chunked(*jargs, jcfg, jnum)
        ssm.ssd_chunked(*targs, cfg, tnum)
        return
    with pytest.raises(AssertionError) as ref:
        jssm.ssd_chunked(*jargs, jcfg, jnum)
    assert ref.value.args[0] == (seq, cfg.ssm.chunk)
    with pytest.raises(ValueError, match=rf"\({seq}, {cfg.ssm.chunk}\)"):
        ssm.ssd_chunked(*targs, cfg, tnum)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seq", [2, 13, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_prefill_and_decode_match_reference(arch, seq, name):
    """``ssm_prefill`` (a prompt shorter than the conv window, one partial
    chunk, two chunks) then three ``ssm_decode`` steps, each on the
    previous state: the outputs and both state leaves after every call.
    The decode writes the state it is handed in place."""
    jcfg, cfg, jp, p = _mixer_params(arch)
    rng = np.random.default_rng(seq)
    x = rng.normal(0, 1, (2, seq, cfg.d_model)).astype(np.float32)
    jnum, tnum = _numerics(name)
    jy, jst = jssm.ssm_prefill(jp, jnp.asarray(x), jcfg, jnum)
    ty, tst = ssm.ssm_prefill(p, torch.from_numpy(x), cfg, tnum)
    _close(ty, jy, name)
    _close(tst.conv, jst.conv, name)
    _close(tst.ssm, jst.ssm, name)
    if seq < cfg.ssm.d_conv - 1:  # the zero left pad
        assert not tst.conv[:, :cfg.ssm.d_conv - 1 - seq].any()
    for step in range(3):
        xd = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = jssm.ssm_decode(jp, jnp.asarray(xd), jst, jcfg, jnum)
        ptrs = [t.data_ptr() for t in tst]
        ty, got = ssm.ssm_decode(p, torch.from_numpy(xd), tst, cfg, tnum)
        assert got is tst and [t.data_ptr() for t in got] == ptrs
        _close(ty, jy, name)
        _close(tst.conv, jst.conv, name)
        _close(tst.ssm, jst.ssm, name)


def test_state_specs_match_reference():
    """The state leaves' shapes and dtypes: conv in the parameter dtype,
    the recurrent state float32 whatever it is."""
    for arch in ARCHS:
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                        (torch.float32, jnp.float32)):
            cfg = base.get_config(arch)
            got = ssm.ssm_state_specs(cfg, 3, dt)
            want = jssm.ssm_state_specs(jbase.get_config(arch), 3, jdt)
            assert got.conv.shape == want.conv.shape and got.conv.dtype == dt
            assert got.ssm.shape == want.ssm.shape
            assert got.ssm.dtype == torch.float32 == getattr(
                torch, str(want.ssm.dtype))


def test_init_params_follows_the_reference_rules():
    """``init_params`` on Jamba's smoke config: ``a_log`` = log(1..H),
    ``d_skip`` = 1, zero ``dt_bias`` / ``conv_b``, unit norm scales (the
    reference's ``init_tree`` values, leaf for leaf), every other leaf a
    draw inside 2 / sqrt(fan_in); Qwen's QKV bias is a draw in both
    packages (its names do not end in ``bias``)."""
    cfg = base.get_smoke_config("jamba_v0_1_52b")
    jcfg = jbase.get_smoke_config("jamba_v0_1_52b")
    ref = jax.tree.map(np.asarray, jtf.init_params(jax.random.key(0), jcfg))
    got = tf.init_params(cfg, seed=1, device="cpu")
    seen = set()

    def check(name, t):
        want = ref
        for k in name.split("/"):
            want = want[k]
        leaf = name.rsplit("/", 1)[-1]
        assert tuple(t.shape) == want.shape
        if leaf in ("a_log", "d_skip", "dt_bias", "conv_b", "scale"):
            seen.add(leaf)
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-7, atol=0)
        else:
            fan = t.shape[-2] if t.dim() >= 2 else t.shape[-1]
            assert t.abs().max() <= 2 / fan ** 0.5 and t.std() > 0
        return t

    map_tree(check, got)
    assert seen == {"a_log", "d_skip", "dt_bias", "conv_b", "scale"}
    a_log = got["segments"]["seg0"]["0"]["mixer"]["a_log"]
    h = a_log.shape[-1]
    assert torch.equal(a_log[0], torch.log(torch.arange(1.0, h + 1)))
    qwen = tf.init_params(base.get_smoke_config("qwen1_5_110b"), seed=0,
                          device="cpu")
    assert qwen["segments"]["seg0"]["0"]["mixer"]["bq"].std() > 0


@pytest.mark.parametrize("n_layers", [8, 32])
def test_init_rules_on_the_full_jamba_tree(n_layers):
    """The rule and scale ``init_params`` gives every leaf of the full-width
    Jamba tree (specs only, nothing allocated): at 8 layers one unstacked
    period, whose ``a_log`` / ``dt_bias`` / ``d_skip`` are 1-D leaves (the
    fan-in of a 1-D leaf is its length, as the reference's), at 32 four
    stacked ones."""
    cfg = base.get_config("jamba_v0_1_52b").replace(n_layers=n_layers)
    rules = map_tree(lambda n, sp: (tf.init_rule(n, sp.shape), sp.shape),
                     tf.param_shapes(cfg))
    mixer = rules["segments"]["seg0"]["0"]["mixer"]
    h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    stack = () if n_layers == 8 else (n_layers // 8,)
    assert mixer["a_log"] == ("a_log", (*stack, h))
    assert mixer["d_skip"] == ("ones", (*stack, h))
    assert mixer["dt_bias"][0] == mixer["conv_b"][0] == "zeros"
    assert mixer["norm"]["scale"][0] == "ones"
    assert mixer["in_proj"][0] == 1 / cfg.d_model ** 0.5
    attn_ = rules["segments"]["seg0"]["4"]["mixer"]
    assert attn_["wq"][0] == 1 / cfg.d_model ** 0.5
    moe = rules["segments"]["seg0"]["1"]["ffn"]
    assert moe["wo"][0] == 1 / cfg.moe.d_expert ** 0.5


def test_mla_up_projections_stay_drawn():
    """The port matches the init rules on a leaf's own name: MLA's
    ``wq_b`` / ``wkv_b`` are drawn (the reference's suffix test zeroes
    them, which would leave MLA's attention with zero queries and
    values)."""
    p = tf.init_params(base.get_smoke_config("minicpm3_4b"), seed=0,
                       device="cpu")
    mixer = p["segments"]["seg0"]["0"]["mixer"]
    assert mixer["wq_b"].std() > 0 and mixer["wkv_b"].std() > 0
