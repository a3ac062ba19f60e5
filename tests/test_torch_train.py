"""The port's train path (``models.transformer.loss_fn``, ``train.step``,
``train.trainer``, ``launch.train``) against the reference's on the
``yi_6b`` smoke config (float32, two layers), parameters carried over by
``params_from_jax`` and batches by ``make_batch``.

Tolerances are ``tests/system/test_distributed.py``'s: loss at rtol 2e-4,
grad_norm at rtol 2e-3, and every gradient leaf within 2e-3 of its own
largest magnitude. Under interp numerics the gradients pass only through
the float glue (a table read has zero derivative), so whole leaves have
zero gradient (the attention's wq / wk: the table softmax passes none);
those leaves must be exactly zero in both packages. ``attention_core``'s
gradients under exact numerics, where the reference stops the gradient of
the running max, are held at rtol 1e-5 with tied maxima in the rows.
Inside the port: microbatches 2 against 1 (the reference's own rtol 1e-5
/ 1e-3), remat none, block and full bitwise, the Trainer's crash and
resume (rtol 1e-5, the reference's), the CLI on the CPU, and a fused
backend refused for CUDA parameters before any launch.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.data import make_batch as jax_make_batch
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.train.step import StepConfig as JStepConfig
from repro.train.step import make_eval_step as jax_make_eval_step
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.step import train_state_init as jax_train_state_init
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.data import make_batch
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics
from repro_torch.optim import global_norm
from repro_torch.plan import NumericsPlan
from repro_torch.plan.schema import SiteAssign
from repro_torch.train import (StepConfig, Trainer, TrainerConfig,
                               make_eval_step, make_train_step)
from repro_torch.train.step import TrainState, batch_to, loss_and_grads
from repro_torch.util.tree import leaves_with_paths

SEQ, BATCH = 32, 4
LOSS_RTOL, GNORM_RTOL = 2e-4, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def yi():
    jcfg = jax_smoke_config("yi_6b")
    cfg = get_smoke_config("yi_6b")
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    batch = jax_make_batch(jcfg, SEQ, BATCH)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                       cfg, "cpu"),
                batch=batch, jbatch={k: jnp.asarray(v)
                                     for k, v in batch.items()},
                jlib=default_explorer().compile(),
                lib=InterpLibrary.default_library("cpu"), ref={})


def _ref_loss_grads(s, name):
    """The reference's (loss, aux, grads) under backend ``name`` ("exact",
    "interp" unbound, "lib": interp bound to the default library),
    computed once per module."""
    if name not in s["ref"]:
        jn = jax_get_numerics("interp" if name != "exact" else "exact",
                              s["jlib"] if name == "lib" else None)
        (l, m), g = jax.value_and_grad(
            lambda p: jtf.loss_fn(p, s["jbatch"], s["jcfg"], jn),
            has_aux=True)(s["jparams"])
        s["ref"][name] = (float(l), float(m["aux"]),
                          dict(leaves_with_paths(jax.tree.map(np.asarray,
                                                              g))))
    return s["ref"][name]


def _port_numerics(s, name):
    return get_numerics("interp" if name != "exact" else "exact",
                        s["lib"] if name == "lib" else None)


def _assert_grads_close(grads, ref: dict, exact_zero: bool):
    """Every leaf within GNORM_RTOL of its own largest magnitude; the
    leaves whose reference gradient is all zero are all zero here."""
    zero = set()
    for name, g in leaves_with_paths(grads):
        g = g.to(torch.float32).numpy()
        r = ref[name].astype(np.float32)
        scale = np.abs(r).max()
        if scale == 0:
            zero.add(name)
            np.testing.assert_array_equal(g, 0.0, err_msg=name)
            continue
        err = np.abs(g - r).max()
        assert err <= GNORM_RTOL * scale, (name, err, scale)
    if exact_zero:
        assert zero, "interp numerics pass no gradient through the softmax"
    return zero


@pytest.mark.parametrize("name", ["exact", "interp", "lib"])
def test_loss_and_grads_match_reference(yi, name):
    """``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    reference's, under exact, unbound interp and library-bound interp."""
    want_l, want_aux, want_g = _ref_loss_grads(yi, name)
    loss, aux, grads = loss_and_grads(yi["params"], batch_to(yi["batch"],
                                                             "cpu"),
                                      yi["cfg"], _port_numerics(yi, name))
    np.testing.assert_allclose(float(loss), want_l, rtol=LOSS_RTOL)
    assert float(aux) == want_aux == 0.0
    zero = _assert_grads_close(grads, want_g, exact_zero=name != "exact")
    if name != "exact":
        assert {n.rsplit("/", 1)[-1] for n in zero} == {"wq", "wk"}
    want_gn = np.sqrt(sum(np.sum(g.astype(np.float32) ** 2)
                          for g in want_g.values()))
    np.testing.assert_allclose(float(global_norm(grads)), want_gn,
                               rtol=GNORM_RTOL)


def test_interp_tracks_exact(yi):
    """The reference's own bound between the two backends' losses
    (``tests/models/test_smoke.py``), on the port."""
    b = batch_to(yi["batch"], "cpu")
    exact = float(tf.loss_fn(yi["params"], b, yi["cfg"],
                             get_numerics("exact"))[0])
    interp = float(tf.loss_fn(yi["params"], b, yi["cfg"],
                              _port_numerics(yi, "lib"))[0])
    assert abs(exact - interp) < 0.15 * max(1.0, abs(exact))


def _attention_inputs(sq, tie: bool):
    """q / k / v (B 2, H 4 over KV 2, D 8) from a seed; with ``tie`` each
    odd key duplicates the key before it, so every query row scores keys
    in equal pairs, its maximum among them."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, sq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, sq, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 8)).astype(np.float32)
    if tie:
        k[:, 1::2] = k[:, 0::2]
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (2, sq)).copy()
    w = rng.standard_normal((2, sq, 4, 8)).astype(np.float32)
    return q, k, v, pos, w


class _Rational:
    """A backend whose exp_neg, 1 / (1 - x), is differentiable but not
    shift-invariant: a softmax built on it has a gradient through the row
    max unless the max is detached, as the reference stops its gradient.
    Plain operators only, so one instance serves both packages."""

    name = "rational"

    @staticmethod
    def exp_neg(x):
        return 1.0 / (1.0 - x)

    @staticmethod
    def recip_pos(x):
        return 1.0 / x


@pytest.mark.parametrize("chunks", [1, 2, 4], ids=lambda c: f"nk{c}")
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("backend", ["exact", "rational"])
def test_attention_core_grads_match_reference(chunks, causal, backend):
    """d/d(q, k, v) of sum(w * attention_core(...)): one chunk, and the
    chunked glue loop with 2 and 4 query / key chunks, at rtol 1e-5
    (float32) against ``jax.grad`` of the reference's, whose running max
    carries no gradient; each even key duplicates the one before it, so
    maxima tie. Under exact numerics the max's path cancels to rounding;
    under the non-exponential ``_Rational`` weight it does not, so a
    gradient through the max shows at once."""
    sq = 16
    q, k, v, pos, w = _attention_inputs(sq, tie=True)
    kw = dict(causal=causal, q_chunk=sq // chunks, kv_chunk=sq // chunks)
    s_ref = jnp.einsum("bqhd,bskd->bhqs", q.reshape(2, sq, 4, 8),
                       np.repeat(k, 2, axis=2))
    assert (np.sort(np.asarray(s_ref), -1)[..., -1]
            == np.sort(np.asarray(s_ref), -1)[..., -2]).any()

    def jf(q_, k_, v_):
        o = jattn.attention_core(q_, k_, v_, jnp.asarray(pos),
                                 jnp.asarray(pos), jnum, **kw)
        return jnp.sum(o * w)

    jnum, num = ((jax_get_numerics("exact"), get_numerics("exact"))
                 if backend == "exact" else (_Rational(), _Rational()))
    want = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = attn.attention_core(*ts, torch.from_numpy(pos), torch.from_numpy(pos),
                            num, **kw)
    got = torch.autograd.grad(torch.sum(o * torch.from_numpy(w)), ts)
    for g, r, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(r)).max(),
                                   err_msg=n)


@pytest.mark.parametrize("site", ["approx_softmax", "InterpNumerics",
                                  "GuardedNumerics"])
def test_softmax_sites_stop_the_max_gradient(site, monkeypatch):
    """The three table softmaxes detach the row max where the reference
    stops its gradient: with the table reads replaced by ``_Rational``'s
    differentiable weight in both packages, d/dx of sum(w * softmax(x))
    matches ``jax.grad`` of the reference's at rtol 1e-5, ties in the
    rows included."""
    import repro.numerics.ops as jops
    from repro.numerics.guard import GuardedNumerics as JGuarded
    from repro_torch.numerics import ops
    from repro_torch.numerics.guard import GuardedNumerics

    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    x[:, 4] = x.max(-1)  # a tied maximum in every row
    w = rng.standard_normal((6, 9)).astype(np.float32)

    def rational(cls):
        return type("R", (cls,), {
            "exp_neg": lambda self, v: _Rational.exp_neg(v),
            "recip_pos": lambda self, v: _Rational.recip_pos(v)})(None)

    if site == "approx_softmax":
        for mod in (jops, ops):
            monkeypatch.setattr(mod, "approx_exp_neg",
                                lambda v, d=None: _Rational.exp_neg(v))
            monkeypatch.setattr(mod, "approx_recip_pos",
                                lambda v, d=None: _Rational.recip_pos(v))
        jf, f = jops.approx_softmax, ops.approx_softmax
    elif site == "InterpNumerics":
        jf = rational(jops.InterpNumerics).softmax
        f = rational(ops.InterpNumerics).softmax
    else:
        jf = JGuarded(rational(jops.InterpNumerics)).softmax
        f = GuardedNumerics(rational(ops.InterpNumerics)).softmax
    want = jax.grad(lambda v: jnp.sum(jf(v) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = torch.autograd.grad(torch.sum(f(t) * torch.from_numpy(w)), t)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_one_train_step_matches_reference(yi):
    """One whole step from one state in both packages (the reference's
    state carried over by ``train_state_from_jax``): loss, lr and
    grad_norm, and the new parameters. At step 1 the update is lr * g / (|g|
    + eps) for the clipped gradient g (about lr in magnitude), plus the
    weight decay: within 1e-2 * lr of the reference's wherever |g| > 1e-6
    (100 eps) or g = 0 (rows of tokens not in the batch), and within 2 *
    lr on the few elements whose g is so close to zero that the packages'
    float rounding moves g / (|g| + eps) itself."""
    sc = dict(peak_lr=1e-3, warmup=0, total_steps=10)
    jstate = jax_train_state_init(jax.random.key(0), yi["jcfg"])
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), yi["cfg"],
                                 "cpu")
    jnew, jm = jax_make_train_step(yi["jcfg"], JStepConfig(**sc))(
        jstate, yi["jbatch"], jnp.asarray(0))
    new, m = make_train_step(yi["cfg"], StepConfig(**sc))(state, yi["batch"],
                                                          0)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GNORM_RTOL)
    assert float(m["lr"]) == float(jm["lr"])
    assert int(new.opt.step) == 1
    # the same parameters as the yi fixture's: the reference's key 0
    _, _, g_ref = _ref_loss_grads(yi, "exact")
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jnew.params)))
    loose = total = 0
    for name, t in leaves_with_paths(new.params):
        d = np.abs(t.numpy() - want[name])
        g = np.abs(g_ref[name]) * clip
        tight = (g > 1e-6) | (g == 0)  # no gradient: decay alone
        assert (d[tight] <= 1e-2 * sc["peak_lr"]).all(), name
        assert (d <= 2 * sc["peak_lr"]).all(), name
        loose, total = loose + int((~tight).sum()), total + d.size
    assert loose < 0.01 * total


def test_eval_step_matches_reference(yi):
    got = make_eval_step(yi["cfg"])(yi["params"], yi["batch"])
    want = jax_make_eval_step(yi["jcfg"])(yi["jparams"], yi["jbatch"])
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)


def test_microbatches_match_full_batch(yi):
    """The reference's check on the port: 2 microbatches (float32
    accumulation, divided by 2) against the whole batch."""
    cfg = yi["cfg"].replace(remat="none")
    s0 = TrainState(yi["params"], *train_state_from_jax(
        jax.tree.map(np.asarray, jax_train_state_init(
            jax.random.key(0), yi["jcfg"])), cfg, "cpu")[1:])
    m1 = make_train_step(cfg, StepConfig(microbatches=1, peak_lr=1e-3,
                                         warmup=0))(s0, yi["batch"], 0)[1]
    m2 = make_train_step(cfg, StepConfig(microbatches=2, peak_lr=1e-3,
                                         warmup=0))(s0, yi["batch"], 0)[1]
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-3)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, StepConfig(microbatches=3))(s0, yi["batch"], 0)


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_remat_policies_bitwise(arch):
    """none, block (matmul outputs saved) and full recomputation give the
    same loss and gradients, bit for bit, under interp numerics."""
    base = get_smoke_config(arch)
    params = tf.init_params(base, 0, "cpu")
    batch = batch_to(make_batch(base, SEQ, 2), "cpu")
    lib = InterpLibrary.default_library("cpu")
    out = {}
    for remat in ("none", "block", "full"):
        cfg = base.replace(remat=remat, numerics="interp")
        out[remat] = loss_and_grads(params, batch, cfg,
                                    get_numerics(cfg, lib))
    for remat in ("block", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert torch.equal(out[remat][1], out["none"][1])
        for (n, a), (_, b) in zip(leaves_with_paths(out[remat][2]),
                                  leaves_with_paths(out["none"][2])):
            assert torch.equal(a, b), (remat, n)
    with pytest.raises(ValueError, match="remat"):
        tf.loss_fn(params, batch, base.replace(remat="some"),
                   get_numerics("exact"))


def _tc(tmp_path, steps, every=2):
    return TrainerConfig(steps=steps, ckpt_dir=str(tmp_path),
                         ckpt_every=every, log_every=100, seq_len=32,
                         global_batch=4,
                         step=StepConfig(total_steps=steps, warmup=2,
                                         peak_lr=1e-3))


def test_trainer_loss_decreases(tmp_path):
    cfg = get_smoke_config("yi_6b").replace(n_layers=2)
    hist = Trainer(cfg, _tc(tmp_path, 8), device="cpu").run()
    assert len(hist) == 8
    assert hist[-1]["loss"] < hist[0]["loss"] + 0.5
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_trainer_crash_resume(tmp_path):
    """6 steps straight against 4 steps ("crash" after step 3: the last
    checkpoint is step 2), then a new trainer that resumes at step 3 with
    the data skipped ahead: the final loss at the reference's rtol 1e-5
    (bitwise on the CPU)."""
    cfg = get_smoke_config("mamba2_130m").replace(n_layers=2)
    straight = Trainer(cfg, _tc(tmp_path / "a", 6), device="cpu").run()
    Trainer(cfg, _tc(tmp_path / "b", 4), device="cpu").run()
    t3 = Trainer(cfg, _tc(tmp_path / "b", 6), device="cpu")
    assert t3.start_step == 3
    resumed = t3.run()
    assert [h["step"] for h in resumed] == [3, 4, 5]
    np.testing.assert_allclose(straight[-1]["loss"], resumed[-1]["loss"],
                               rtol=1e-5)
    assert straight[-1]["loss"] == resumed[-1]["loss"]


def test_trainer_request_stop_saves(tmp_path):
    cfg = get_smoke_config("yi_6b").replace(n_layers=2)
    t = Trainer(cfg, _tc(tmp_path, 6, every=4), device="cpu")
    t.request_stop()
    hist = t.run()
    assert len(hist) == 1
    from repro_torch.checkpoint import latest_step
    assert latest_step(tmp_path) == 0
    t2 = Trainer(cfg, _tc(tmp_path, 6, every=5), device="cpu")
    assert t2.start_step == 1
    t2.request_stop()
    t2.run()
    assert latest_step(tmp_path) == 1  # step 1 is no save step: forced


def test_cli_smoke_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    args = ["--arch", "yi_6b", "--smoke", "--device", "cpu", "--steps", "3",
            "--seq-len", "16", "--global-batch", "2", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--numerics", "interp"]
    hist = main(args)
    out = capsys.readouterr().out.strip().splitlines()
    report = json.loads(out[-1])
    assert report["device"] == "cpu" and report["last_step"] == 2
    assert report["numerics"] == "interp" and len(hist) == 3
    assert np.isfinite(report["final_loss"])
    assert (tmp_path / "yi_6b" / "LATEST").read_text() == "2"
    args[args.index("--steps") + 1] = "5"
    main(args)  # resumes after step 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "start_step"] == 3
    with pytest.raises(ValueError, match="mesh"):
        main(args + ["--model-parallel", "2"])


class _CudaLeaf:
    """Stands for a CUDA parameter: the refusal reads ``is_cuda`` alone."""

    is_cuda = True


def test_fused_backend_refused_before_any_launch(monkeypatch):
    """A fused backend (or a plan with one fused site) with CUDA
    parameters raises ``ValueError`` before anything is built or read;
    on the CPU the fused plain versions train."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "load", lambda: pytest.fail("built"))
    lib = InterpLibrary.default_library("cpu")
    cfg = get_smoke_config("yi_6b")
    state = TrainState({"w": _CudaLeaf()}, None, None)
    plan = NumericsPlan.uniform("interp", cfg.n_layers)
    layers = list(plan.layers)
    layers[1] = layers[1].with_site("act", SiteAssign("interp-fused"))
    for c in (cfg.replace(numerics="interp-fused"),
              cfg.replace(plan=dataclasses.replace(plan,
                                                   layers=tuple(layers)))):
        step = make_train_step(c, StepConfig(), lib)
        with pytest.raises(ValueError, match="no backward"):
            step(state, {}, 0)
    # the unfused interp backend is not refused
    step = make_train_step(cfg.replace(numerics="interp"), StepConfig(), lib)
    with pytest.raises(AttributeError):
        step(state, {}, 0)  # past the check: the stand-in has no device
    # CPU parameters: the plain versions are torch ops and differentiate
    params = tf.init_params(cfg, 0, "cpu")
    loss, _, grads = loss_and_grads(
        params, batch_to(make_batch(cfg, 16, 2), "cpu"), cfg,
        get_numerics("interp-fused", lib))
    assert np.isfinite(float(loss))
    assert float(global_norm(grads)) > 0


def test_load_balance_loss_matches_reference():
    """The MoE aux from probabilities with exact ties (quantized table
    probabilities tie): the port's stable top-k picks what the
    reference's ``lax.top_k`` picks."""
    from repro.models.moe import load_balance_loss_from_probs as jlb
    from repro_torch.models.moe import load_balance_loss_from_probs

    cfg = get_smoke_config("deepseek_moe_16b")
    jcfg = jax_smoke_config("deepseek_moe_16b")
    rng = np.random.default_rng(3)
    e = cfg.moe.n_experts
    probs = np.round(rng.dirichlet(np.ones(e), size=(2, 16)) * 8) / 8
    probs = probs.astype(np.float32)
    got = load_balance_loss_from_probs(torch.from_numpy(probs), cfg)
    want = jlb(jnp.asarray(probs), jcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
