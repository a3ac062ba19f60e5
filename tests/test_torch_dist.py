"""Distributed semantics of the port on the CPU: gloo processes, one per
rank.

Each launch writes a rank script under its tmp dir and starts its ranks as
``subprocess.Popen`` processes (``OMP_NUM_THREADS=1``, one torch thread)
that meet through a ``file://`` store in that dir (no TCP port to collide
with another test), with ``init_process_group(timeout=60 s)``. A launch
has a hard limit: when it passes, or when any rank exits with an error,
every rank is killed and the launch fails, so a hung collective fails its
tests and never stalls the suite. Rank 0 prints its findings as one
``RESULT`` JSON line; the tests assert on them. Each launch runs once per
module (a fixture) and serves several tests.

The contracts, from the reference's ``tests/system/test_sharded_serving.py``
and ``test_distributed.py``: a ``("data", "tp")``-meshed engine emits the
unmeshed engine's token streams at (2, 1), (1, 2), (2, 2) (and (1, 4),
where ``tp`` does not divide the KV heads) with ``aot_misses == 0``; the
uniform interp-fused plan; ROM verification and the degradation ladder on
sharded state; sharded decode logits and the sharded train step within
the reference's stated tolerances (the reference's own two tests fail on
its jax, so these are held inside the port: sharded against single);
elastic resharding, the GPipe pipeline, the two launchers, and the fleet's
probe split (in this process).
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
LIMIT_S = 240

PRELUDE = """
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{TMP}/store",
                        rank=RANK, world_size=WORLD,
                        timeout=datetime.timedelta(seconds=60))
RES = {}

def done():
    if RANK == 0:
        print("RESULT " + json.dumps(RES), flush=True)
    dist.destroy_process_group()

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import make_mesh, make_serve_mesh
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine

def serve(cfg, params, prompts, **kw):
    eng = ServeEngine(cfg, params, slots=4, cache_len=48, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new=5))
    out = {r.rid: list(r.out) for r in eng.run()}
    eng.close()
    return out, eng

def prompts_for(cfg, lens=(5, 11, 3, 16, 9, 2)):
    rng = np.random.default_rng(7)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]
"""


def _launch(tmp: pathlib.Path, n: int, body: str, *, prelude: bool = True,
            argv=(), env_extra=None) -> list[str]:
    """Start ``n`` ranks of ``body`` and return their outputs; fails (after
    killing every rank) past ``LIMIT_S`` or when a rank exits non-zero."""
    tmp.mkdir(parents=True, exist_ok=True)
    script = tmp / "rank.py"
    script.write_text((PRELUDE if prelude else "") + textwrap.dedent(body))
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                   RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   **(env_extra or {}))
        env.pop("JAX_PLATFORMS", None)
        cmd = ([sys.executable, str(script), str(r), str(n), str(tmp)]
               if prelude else [sys.executable, str(script), *argv])
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(tmp),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    t0 = time.monotonic()
    failed = None
    while any(p.poll() is None for p in procs):
        if time.monotonic() - t0 > LIMIT_S:
            failed = f"hard limit of {LIMIT_S} s"
        elif any(p.poll() not in (None, 0) for p in procs):
            failed = "a rank failed"
            time.sleep(1.0)  # let its traceback flush
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.05)
    outs = [p.communicate()[0] for p in procs]
    if failed or any(p.returncode for p in procs):
        detail = "\n".join(f"--- rank {r} (rc {p.returncode})\n{o[-4000:]}"
                           for r, (p, o) in enumerate(zip(procs, outs)))
        pytest.fail(f"{failed or 'a rank failed'}:\n{detail}")
    return outs


def _result(outs: list[str]) -> dict:
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[7:])
    pytest.fail(f"rank 0 printed no RESULT:\n{outs[0][-4000:]}")


# ---------------------------------------------------------------------------
# serving: yi_6b token streams on every mesh shape
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    return _result(_launch(tmp_path_factory.mktemp("serve"), 4, """
    cfg = get_smoke_config("yi_6b")
    params = tf.init_params(cfg, 0, "cpu")
    prompts = prompts_for(cfg)
    ref, _ = serve(cfg, params, prompts)
    for d, t in ((2, 1), (1, 2), (2, 2), (1, 4)):
        m = make_serve_mesh(d, t)
        if m.coords is None:
            continue
        got, eng = serve(cfg, params, prompts, mesh=m, aot_buckets=(8, 16),
                         async_host=True)
        RES[f"{d}x{t}"] = {"equal": got == ref, "streams": got,
                           **{k: eng.stats[k] for k in (
                               "aot_misses", "aot_hits", "aot_reshards",
                               "packed_admits", "collectives")}}
        RES[f"{d}x{t}"]["kv_heads"] = int(eng.caches.k.shape[2])
    RES["ref"] = ref
    done()
    """))


@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2"])
def test_meshed_engine_streams_equal_single(serve_run, shape):
    got = serve_run[shape]
    assert got["streams"] == serve_run["ref"], shape
    assert got["equal"]
    assert got["aot_misses"] == 0 and got["aot_hits"] > 0, got
    assert got["aot_reshards"] == 0 and got["packed_admits"] > 0, got
    assert got["collectives"]["all_reduce"] > 0
    assert got["collectives"]["all_gather"] > 0
    assert got["kv_heads"] == 2 // int(shape[-1])  # this rank's KV heads


def test_meshed_engine_replicates_kv_heads_tp_does_not_divide(serve_run):
    """yi_6b smoke has 2 KV heads: at tp = 4 every rank holds both (the
    reference's cache spec replicates the pool there) and attends with its
    own query head's group."""
    got = serve_run["1x4"]
    assert got["streams"] == serve_run["ref"]
    assert got["kv_heads"] == 2


# ---------------------------------------------------------------------------
# plans, ROM verification, the ladder, the ROM contract, refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rom_run(tmp_path_factory):
    return _result(_launch(tmp_path_factory.mktemp("rom"), 4, """
    from repro_torch.faults import flip_rom_bit
    from repro_torch.kernels.interp.ops import assert_rom_replicated
    from repro_torch.plan.schema import SlotSpec, plan_for

    cfg = get_smoke_config("yi_6b")
    params = tf.init_params(cfg, 0, "cpu")
    prompts = prompts_for(cfg)
    m = make_serve_mesh(2, 2)

    cfgp = cfg.replace(plan=plan_for(cfg, backend="interp-fused",
                                     slot=SlotSpec(lookup_bits=6)))
    ref, leg = serve(cfgp, params, prompts)
    got, _ = serve(cfgp, params, prompts, library=leg.library, mesh=m,
                   aot_buckets=(8, 16))
    RES["plan_equal"] = got == ref

    cfg_i = cfg.replace(numerics="interp")
    ref, leg = serve(cfg_i, params, prompts)
    got, eng = serve(cfg_i, params, prompts, library=leg.library, mesh=m,
                     verify_rom_every=2, aot_buckets=(8, 16))
    RES["verify"] = {"equal": got == ref,
                     "rom_verifies": eng.stats["rom_verifies"],
                     "rom_faults": eng.stats["rom_faults"]}
    eng2 = ServeEngine(cfg_i, params, slots=4, cache_len=48,
                       library=leg.library, mesh=m, verify_rom_every=1,
                       device="cpu")
    eng2.library = flip_rom_bit(eng2.library, seed=9)
    for i, p in enumerate(prompts):
        eng2.submit(Request(i, p, max_new=5))
    fin = eng2.run()
    RES["flip"] = {"rom_faults": eng2.stats["rom_faults"],
                   "degradations": eng2.stats["degradations"],
                   "finished": len(fin), "failed": len(eng2.failed)}

    rom = torch.arange(96, dtype=torch.int32).reshape(8, 4, 3)
    assert_rom_replicated(rom, mesh=m)
    refused = {}
    for what, x in (("contents", rom + (RANK == 3)),
                    ("shard", rom[:4] if RANK % 2 else rom[4:])):
        try:
            assert_rom_replicated(x, mesh=m)
            refused[what] = False
        except ValueError as e:
            refused[what] = "replicated ROM" in str(e)
    RES["refused"] = refused
    try:
        m.check_device(torch.device("cuda"))
        RES["cuda_on_gloo"] = "accepted"
    except ValueError as e:
        RES["cuda_on_gloo"] = str(e)
    try:
        make_serve_mesh(4, 2)
        RES["oversized"] = "accepted"
    except ValueError as e:
        RES["oversized"] = str(e)
    done()
    """))


def test_meshed_engine_uniform_plan_equals_single(rom_run):
    assert rom_run["plan_equal"]


def test_rom_verify_on_sharded_state(rom_run):
    v = rom_run["verify"]
    assert v["equal"] and v["rom_verifies"] >= 1 and v["rom_faults"] == 0


def test_corrupt_rom_degrades_meshed_engine(rom_run):
    f = rom_run["flip"]
    assert f["rom_faults"] >= 1 and f["degradations"] >= 1, f
    assert f["finished"] == 6 and f["failed"] == 0


def test_assert_rom_replicated_refuses_a_differing_rom(rom_run):
    assert rom_run["refused"] == {"contents": True, "shard": True}


def test_mesh_refusals(rom_run):
    assert "nccl" in rom_run["cuda_on_gloo"]
    assert "needs 8 devices" in rom_run["oversized"]


# ---------------------------------------------------------------------------
# families: QKV bias logits, MoE, SSM / MLA refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def family_run(tmp_path_factory):
    return _result(_launch(tmp_path_factory.mktemp("fam"), 4, """
    from repro_torch.launch import sharding as shlib
    from repro_torch.numerics.ops import get_numerics

    # qwen1_5_110b (QKV bias), 2 layers: decode logits meshed (2, 2)
    cfg = get_smoke_config("qwen1_5_110b").replace(n_layers=2)
    num = get_numerics("exact")
    params = tf.init_params(cfg, 0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16)))
    logits, caches = tf.prefill(params, toks, cfg, num, 32)
    tok = torch.argmax(logits, -1)
    single, _ = tf.decode_step(params, tok, 16, caches, cfg, num)
    m = make_serve_mesh(2, 2)
    specs = shlib.placement_specs(params, cfg, m, shlib.SERVE_PARAM_RULES)
    local = shlib.shard_tree(params, specs, m, shlib.glu_leaves(params, cfg))
    rows = slice(2 * m.index("data"), 2 * m.index("data") + 2)
    _, lc = tf.prefill(local, toks[rows], cfg, num, 32, mesh=m)
    out, _ = tf.decode_step(local, tok[rows], 16, lc, cfg, num, mesh=m)
    out = m.all_gather(out, "data", 0)
    RES["qwen_max_abs"] = float((out - single).abs().max())
    RES["qwen_close"] = bool(torch.allclose(out, single, rtol=5e-3,
                                            atol=5e-3))
    RES["qwen_tokens"] = bool(torch.equal(out.argmax(-1),
                                          single.argmax(-1)))

    # deepseek_moe_16b smoke at (1, 2): tokens equal
    cfg = get_smoke_config("deepseek_moe_16b")
    params = tf.init_params(cfg, 0, "cpu")
    prompts = prompts_for(cfg)
    ref, _ = serve(cfg, params, prompts)
    m = make_serve_mesh(1, 2)
    if m.coords is not None:
        got, _ = serve(cfg, params, prompts, mesh=m)
        RES["moe_equal"] = got == ref

    # mamba2 (SSM), minicpm3 (MLA), jamba (hybrid): over data and over tp
    # (heads split), and a variant of each mixer whose heads tp = 2 does
    # not divide (replicated over tp, run whole on every rank)
    variants = (("mamba2_130m", get_smoke_config("mamba2_130m")),
                ("minicpm3_4b", get_smoke_config("minicpm3_4b")),
                ("jamba_v0_1_52b", get_smoke_config("jamba_v0_1_52b")),
                ("gqa_whole", get_smoke_config("yi_6b").replace(
                    n_heads=3, n_kv_heads=1)),
                ("mla_whole", get_smoke_config("minicpm3_4b").replace(
                    n_heads=3, n_kv_heads=3)),
                ("ssm_whole", get_smoke_config("mamba2_130m").replace(
                    ssm=get_smoke_config("mamba2_130m").ssm.__class__(
                        d_state=15, d_conv=4, expand=2, head_dim=16,
                        n_groups=1, chunk=32))))
    num = get_numerics("exact")
    for arch, cfg in variants:
        params = tf.init_params(cfg, 0, "cpu")
        prompts = prompts_for(cfg)
        ref, _ = serve(cfg, params, prompts)
        for d, t in ((2, 1), (1, 2)):
            m = make_serve_mesh(d, t)
            if m.coords is not None:
                got, _ = serve(cfg, params, prompts, mesh=m)
                RES[f"{arch}_{d}x{t}"] = got == ref
        # decode logits at (1, 2) against one process
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 32)))
        logits, caches = tf.prefill(params, toks, cfg, num, 48)
        tok = torch.argmax(logits, -1)
        single, _ = tf.decode_step(params, tok, 32, caches, cfg, num)
        m = make_serve_mesh(1, 2)
        if m.coords is not None:
            specs = shlib.placement_specs(params, cfg, m,
                                          shlib.SERVE_PARAM_RULES)
            local = shlib.shard_tree(params, specs, m,
                                     shlib.split_leaves(params, cfg, m))
            _, lc = tf.prefill(local, toks, cfg, num, 48, mesh=m)
            out, _ = tf.decode_step(local, tok, 32, lc, cfg, num, mesh=m)
            RES[f"{arch}_max_abs"] = float((out - single).abs().max())
            RES[f"{arch}_whole"] = shlib.whole_mixer(
                cfg, m, "ssm" if cfg.ssm is not None else
                "mla" if cfg.mla is not None else "attn")
    done()
    """))


def test_sharded_decode_logits_within_reference_tolerance(family_run):
    """The reference's ``test_sharded_decode_matches_single_device`` held
    inside the port at its rtol = atol = 5e-3 (measured: about 1e-6 on the
    CPU, float32)."""
    assert family_run["qwen_close"], family_run["qwen_max_abs"]
    assert family_run["qwen_max_abs"] < 5e-3
    assert family_run["qwen_tokens"]


def test_meshed_moe_engine_streams_equal_single(family_run):
    assert family_run["moe_equal"]


@pytest.mark.parametrize("arch", ["mamba2_130m", "minicpm3_4b",
                                  "jamba_v0_1_52b", "gqa_whole", "mla_whole",
                                  "ssm_whole"])
def test_ssm_and_mla_serve_over_data_and_tp(family_run, arch):
    """The MLA and SSM mixers (and the Jamba hybrid) at (2, 1) and (1, 2):
    token streams equal to the single engine, decode logits within the
    reference's 5e-3 (measured: about 1e-6, float32); the three variants
    whose heads tp = 2 does not divide (GQA, MLA, SSM) run the mixer whole
    on every rank."""
    assert family_run[f"{arch}_2x1"] is True
    assert family_run[f"{arch}_1x2"] is True
    assert family_run[f"{arch}_max_abs"] < 5e-3
    assert family_run[f"{arch}_whole"] == arch.endswith("_whole")


# ---------------------------------------------------------------------------
# training, the Trainer's resume, elastic resharding, the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    return _result(_launch(tmp_path_factory.mktemp("train"), 4, """
    from repro_torch.checkpoint import save
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch.elastic import remesh_state, reshard_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.pipeline import pipeline_apply
    import math, pathlib
    from repro_torch.launch.mesh import trace_mesh
    from repro_torch.launch.xprof import profile_step
    from repro_torch.train.step import (StepConfig, gather_state,
                                        make_train_step, shard_state,
                                        train_specs, train_state_init)
    from repro_torch.util.tree import leaves_with_paths, tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    # the train step at data 2 x model 2 against one process
    cfg = get_smoke_config("yi_6b").replace(n_layers=2)
    batch = make_batch(cfg, 32, 4)
    sc = StepConfig(peak_lr=1e-3, warmup=0)
    _, m1 = make_train_step(cfg, sc)(train_state_init(cfg, sc, 0, "cpu"),
                                     batch, 0)
    mesh = make_host_mesh(2)
    d = mesh.index("data")
    state = shard_state(train_state_init(cfg, sc, 0, "cpu"), cfg, mesh)
    _, m2 = make_train_step(cfg, sc, mesh=mesh)(
        state, {k: v[2 * d:2 * d + 2] for k, v in batch.items()}, 0)
    RES["step"] = {k: [float(m1[k]), float(m2[k])]
                   for k in ("loss", "grad_norm")}
    # ZeRO-3: the state after one step at data 2 x model 2, gathered, leaf
    # by leaf against the single step's (with and without compression):
    # per leaf [max |sharded - single|, max |single|]
    local = {k: v[2 * d:2 * d + 2] for k, v in batch.items()}
    for name, zc in (("plain", sc), ("compress", StepConfig(
            peak_lr=1e-3, warmup=0, compress_pods=True))):
        s1, _ = make_train_step(cfg, zc)(train_state_init(cfg, zc, 0, "cpu"),
                                         batch, 0)
        s2, _ = make_train_step(cfg, zc, mesh=mesh)(shard_state(
            train_state_init(cfg, zc, 0, "cpu"), cfg, mesh), local, 0)
        g2 = gather_state(s2, cfg, mesh)
        parts = {}
        for part, a, b in (("params", s1.params, g2.params),
                           ("master", s1.opt.master, g2.opt.master),
                           ("mu", s1.opt.mu, g2.opt.mu),
                           ("nu", s1.opt.nu, g2.opt.nu),
                           ("residual", s1.residual, g2.residual)):
            if a is None:
                continue
            parts[part] = {
                p: [float((x.float() - y.float()).abs().max())
                    if x.shape == y.shape else float("inf"),
                    float(x.float().abs().max())]
                for (p, x), (_, y) in zip(leaves_with_paths(a),
                                          leaves_with_paths(b))}
        RES[f"zero3_{name}"] = parts
    # ZeRO-3: every leaf split over data holds 1/data of it on this rank
    full = train_state_init(cfg, sc, 0, "cpu")
    specs = train_specs(cfg, mesh)
    sizes = []
    for (path, t), sp, loc in zip(
            leaves_with_paths(full.opt.mu), shlib.spec_leaves(specs),
            tree_leaves(state.opt.mu)):
        axes = {a for e in sp for a in shlib.axes_of(e)}
        sizes.append(["data" in axes, loc.numel() * math.prod(
            mesh.shape[a] for a in axes) == t.numel()])
    RES["zero3"] = {"over_data": sum(d for d, _ in sizes),
                    "leaves": len(sizes), "ok": all(k for _, k in sizes)}
    # a checkpoint of the gathered shards is the unsharded layout, bytes
    whole = gather_state(shard_state(full, cfg, mesh), cfg, mesh)
    if RANK == 0:
        save(f"{TMP}/ck_full", 0, full)
        save(f"{TMP}/ck_sharded", 0, whole)
        a = sorted(pathlib.Path(f"{TMP}/ck_full").rglob("*.npy"))
        b = sorted(pathlib.Path(f"{TMP}/ck_sharded").rglob("*.npy"))
        RES["ckpt_bytes_equal"] = (
            [p.relative_to(f"{TMP}/ck_full") for p in a]
            == [p.relative_to(f"{TMP}/ck_sharded") for p in b]
            and all(x.read_bytes() == y.read_bytes() for x, y in zip(a, b))
            and len(a) > 0)
    dist.barrier()

    # the collectives one step issues on (1, 2) gloo ranks, by kind and
    # axis, against the traced (1, 2) mesh's record of the same step
    m12 = make_mesh((1, 2), ("data", "model"))
    if m12.coords is not None:
        st = shard_state(train_state_init(cfg, sc, 0, "cpu"), cfg, m12)
        m12.log.clear()
        make_train_step(cfg, sc, mesh=m12)(st, batch, 0)
        tm = trace_mesh((1, 2), ("data", "model"))
        prof, _ = profile_step(lambda s, b: make_train_step(
            cfg, sc, mesh=tm)(s, b, 0), st, batch, loops=False)
        RES["coll"] = {"gloo": sorted([*k, n] for k, n in m12.log.items()),
                       "traced": sorted([*k, n] for k, n in tm.log.items()),
                       "profile": prof.collective_count}

    # the other families' tensor-parallel sites: cross attention and the
    # encoder (whisper), the projector (internvl), QKV bias, MoE experts,
    # the window, squared ReLU, MLA, the SSM mixer and the hybrid
    for arch in ("whisper_tiny", "internvl2_2b", "qwen1_5_110b",
                 "deepseek_moe_16b", "mixtral_8x22b", "minitron_8b",
                 "minicpm3_4b", "mamba2_130m", "jamba_v0_1_52b"):
        fc = get_smoke_config(arch)
        fb = make_batch(fc, 16, 4)
        _, f1 = make_train_step(fc, sc)(train_state_init(fc, sc, 0, "cpu"),
                                        fb, 0)
        fs = shard_state(train_state_init(fc, sc, 0, "cpu"), fc, mesh)
        _, f2 = make_train_step(fc, sc, mesh=mesh)(
            fs, {k: v[2 * d:2 * d + 2] for k, v in fb.items()}, 0)
        RES[arch] = {k: [float(f1[k]), float(f2[k])]
                     for k in ("loss", "grad_norm")}

    # the Trainer on the mesh, cut and resumed, against a straight run
    def tc(path, steps):
        return TrainerConfig(steps=steps, ckpt_dir=f"{TMP}/{path}",
                             ckpt_every=2, log_every=100, seq_len=16,
                             global_batch=4, step=StepConfig(warmup=0))
    straight = Trainer(cfg, tc("a", 5), mesh=mesh, device="cpu").run()
    single = Trainer(cfg, tc(f"s{RANK}", 5), device="cpu").run()
    Trainer(cfg, tc("b", 3), mesh=mesh, device="cpu").run()
    t3 = Trainer(cfg, tc("b", 5), mesh=mesh, device="cpu")
    resumed = t3.run()
    RES["trainer"] = {"start": t3.start_step,
                      "straight": [h["loss"] for h in straight],
                      "single": [h["loss"] for h in single],
                      "resumed": [h["loss"] for h in resumed]}

    # elastic: place on (2, 2), save, restore on (1, 2), remesh back
    full = {"embed": {"tok": torch.arange(64.0).reshape(16, 4)},
            "mixer": {"wq": torch.ones(8, 16)}}
    m22 = make_mesh((2, 2), ("data", "model"))
    p22 = remesh_state(full, m22)
    whole = shlib.gather_tree(p22.tree, p22.specs, m22)
    if RANK == 0:
        save(f"{TMP}/ckpt", 3, whole)
    dist.barrier()
    m12 = make_mesh((1, 2), ("data", "model"))
    step, p12 = reshard_checkpoint(f"{TMP}/ckpt", full, m12)
    back = remesh_state(p12, m22)
    ok = [bool(torch.equal(a, b)) for a, b in (
        (shlib.gather_tree(back.tree, back.specs, m22)["embed"]["tok"],
         full["embed"]["tok"]),
        (shlib.gather_tree(back.tree, back.specs, m22)["mixer"]["wq"],
         full["mixer"]["wq"]))]
    if m12.coords is not None:
        g12 = shlib.gather_tree(p12.tree, p12.specs, m12)
        ok.append(bool(torch.equal(g12["embed"]["tok"],
                                   full["embed"]["tok"])))
        ok.append(tuple(p12.tree["embed"]["tok"].shape) == (8, 4))
    RES["elastic"] = {"step": step, "ok": ok,
                      "shard22": list(p22.tree["embed"]["tok"].shape)}

    # the GPipe pipeline at 4 stages against the sequential product
    sm = make_mesh((4,), ("stage",))
    g = torch.Generator().manual_seed(0)
    w = torch.randn(4, 16, 16, generator=g) / 4.0
    x = torch.randn(8, 2, 16, generator=g)
    y = pipeline_apply(w, x, lambda p, h: torch.tanh(h @ p), sm)
    ref = x
    for s in range(4):
        ref = torch.tanh(ref @ w[s])
    RES["pipeline_max_abs"] = float((y - ref).abs().max())
    done()
    """))


def test_sharded_train_step_matches_single(train_run):
    """The reference's ``test_sharded_train_step_matches_single_device``
    held inside the port: loss at rtol 2e-4, grad_norm at rtol 2e-3."""
    (l1, l2), (g1, g2) = train_run["step"]["loss"], \
        train_run["step"]["grad_norm"]
    np.testing.assert_allclose(l2, l1, rtol=2e-4)
    np.testing.assert_allclose(g2, g1, rtol=2e-3)


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_2b",
                                  "qwen1_5_110b", "deepseek_moe_16b",
                                  "mixtral_8x22b", "minitron_8b"])
def test_sharded_train_step_families_match_single(train_run, arch):
    """data 2 x model 2 through every other family's tensor-parallel sites
    (cross attention and the encoder, the projector, QKV bias, the
    experts, the window, squared ReLU), at the same tolerances."""
    (l1, l2), (g1, g2) = train_run[arch]["loss"], train_run[arch]["grad_norm"]
    np.testing.assert_allclose(l2, l1, rtol=2e-4)
    np.testing.assert_allclose(g2, g1, rtol=2e-3)


@pytest.mark.parametrize("arch", ["minicpm3_4b", "mamba2_130m",
                                  "jamba_v0_1_52b"])
def test_mla_and_ssm_train_model_parallel(train_run, arch):
    """The MLA and SSM mixers (and the hybrid) at data 2 x model 2 under
    ZeRO-3: loss at rtol 2e-4, grad_norm at rtol 2e-3."""
    (l1, l2), (g1, g2) = train_run[arch]["loss"], train_run[arch]["grad_norm"]
    np.testing.assert_allclose(l2, l1, rtol=2e-4)
    np.testing.assert_allclose(g2, g1, rtol=2e-3)


def test_zero3_state_is_split_over_data(train_run):
    """Every leaf of the AdamW moments split over ``data`` (ZeRO-3) or
    ``model`` holds 1 / (product of its split axes) of it on this rank;
    the big leaves are split over data."""
    z = train_run["zero3"]
    assert z["ok"] and z["over_data"] >= 5, z


@pytest.mark.parametrize("variant", ["plain", "compress"])
def test_zero3_step_state_matches_single(train_run, variant):
    """One step at data 2 x model 2 under ZeRO-3, its state gathered,
    against the unsharded step's, every leaf: the parameters and the
    AdamW master within 2e-4 of the leaf's largest magnitude, the moments
    (and under ``compress_pods`` the error-feedback residual, whose int8
    scale takes its amax over the leaf's shards) within 2e-3 (measured on
    the CPU: 3.6e-5, 1.8e-6 and 3.8e-4). An update on the wrong shard
    moves a parameter by about the learning rate (1e-3), far past 2e-4 of
    the smoke leaves' magnitudes."""
    parts = train_run[f"zero3_{variant}"]
    want = {"params", "master", "mu", "nu"} | (
        {"residual"} if variant == "compress" else set())
    assert set(parts) == want
    for part, leaves in parts.items():
        tol = 2e-4 if part in ("params", "master") else 2e-3
        assert leaves
        for path, (err, mag) in leaves.items():
            assert err <= tol * mag, (part, path, err, mag)


def test_zero3_checkpoint_is_the_unsharded_layout(train_run):
    """The state sharded over data 2 x model 2, gathered and saved, is
    byte for byte the checkpoint of the unsharded state (file by file)."""
    assert train_run["ckpt_bytes_equal"] is True


def test_collectives_of_a_step_equal_the_traced_mesh(train_run):
    """One train step on (1, 2) gloo ranks issues the collectives, by kind
    and axis, that the traced (1, 2) mesh records for the same step under
    ``profile_step`` (every layer traced: ``loops=False``); the profile
    counts those over groups larger than one, as the reference's
    ``analyze_hlo`` does."""
    c = train_run["coll"]
    assert c["gloo"] == c["traced"] and c["gloo"]
    want = {}
    for kind, axis, n in c["gloo"]:
        if axis == "model":
            want[kind] = want.get(kind, 0) + n
    assert c["profile"] == want


def test_meshed_trainer_resumes(train_run):
    """The Trainer at data 2 x model 2 (ZeRO-3), cut after 3 steps and
    resumed, repeats its straight run; its 5 losses are the unsharded
    Trainer's at the loss tolerance 2e-4 (measured on the CPU: 1e-7)."""
    t = train_run["trainer"]
    assert t["start"] == 3
    np.testing.assert_allclose(t["resumed"], t["straight"][3:], rtol=1e-5)
    assert len(t["straight"]) == len(t["single"]) == 5
    np.testing.assert_allclose(t["straight"], t["single"], rtol=2e-4)


def test_elastic_reshard_roundtrip(train_run):
    e = train_run["elastic"]
    assert e["step"] == 3 and all(e["ok"]) and len(e["ok"]) == 4
    assert e["shard22"] == [8, 2]  # vocab over model, d over data


def test_pipeline_matches_sequential(train_run):
    assert train_run["pipeline_max_abs"] < 1e-5


# ---------------------------------------------------------------------------
# the launchers on two ranks
# ---------------------------------------------------------------------------

def _cli(tmp_path, module: str, args: list[str]) -> list[str]:
    body = f"""
    import runpy, sys
    import torch
    torch.set_num_threads(1)
    sys.argv = ["{module}"] + sys.argv[1:]
    runpy.run_module("{module}", run_name="__main__")
    """
    return _launch(tmp_path, 2, body, prelude=False, argv=[
        *args, "--dist-url", f"file://{tmp_path}/store"])


def test_serve_cli_on_a_mesh(tmp_path, capsys):
    from repro_torch.launch import serve

    common = ["--arch", "yi_6b", "--smoke", "--device", "cpu",
              "--requests", "3", "--max-new", "4", "--aot-buckets", "8,16"]
    serve.main(common)
    single = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("request ")]
    outs = _cli(tmp_path, "repro_torch.launch.serve",
                [*common, "--mesh", "2x1"])
    meshed = [ln for ln in outs[0].splitlines() if ln.startswith("request ")]
    assert meshed == single and len(single) == 3
    assert not [ln for ln in outs[1].splitlines()
                if ln.startswith(("request ", "{"))]  # rank 1 is quiet
    last = json.loads(outs[0].strip().splitlines()[-1])
    assert last["mesh"] == "2x1" and last["stats"]["collectives"][
        "all_gather"] > 0


def test_train_cli_model_parallel(tmp_path, capsys):
    from repro_torch.launch import train

    common = ["--arch", "yi_6b", "--smoke", "--device", "cpu", "--steps",
              "3", "--seq-len", "16", "--global-batch", "2"]
    train.main([*common, "--ckpt-dir", str(tmp_path / "single")])
    single = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    outs = _cli(tmp_path / "mesh", "repro_torch.launch.train",
                [*common, "--model-parallel", "2", "--ckpt-dir",
                 str(tmp_path / "meshed")])
    got = json.loads(outs[0].strip().splitlines()[-1])
    assert got["mesh"] == {"data": 1, "model": 2}
    assert got["last_step"] == single["last_step"] == 2
    np.testing.assert_allclose(got["final_loss"], single["final_loss"],
                               rtol=2e-4)
    assert not outs[1].strip()


# ---------------------------------------------------------------------------
# the fleet's probe split (one process)
# ---------------------------------------------------------------------------

def test_fleet_probe_split_equals_one_program():
    """``shards=8`` over 8 CPU device entries equals ``shards=1`` bitwise
    on the reference test's 4 probes (4 sentinel probes pad the split),
    and every verdict equals the reference's exact ``batched``."""
    from repro.core import batched as jbatched
    from repro.core.funcspec import get_spec as jget_spec
    from repro_torch.core import fleet
    from repro_torch.core.funcspec import get_spec
    from repro_torch.kernels.dspace.ops import fleet_region_envelopes_device

    pairs = [("recip", 8, 3), ("exp2", 8, 3), ("silu", 8, 3), ("recip", 8, 4)]
    bounds = [get_spec(k, b).region_bounds(r) for k, b, r in pairs]
    stack = fleet.stack_bounds(bounds)
    one = fleet_region_envelopes_device(stack.L, stack.U, shards=1,
                                        device="cpu")
    sh8 = fleet_region_envelopes_device(stack.L, stack.U, shards=8,
                                        device="cpu", devices=["cpu"] * 8)
    for a, b in zip(one, sh8):
        np.testing.assert_array_equal(a, b)
    assert one[0].shape[0] == 4 * 16
    # the default device list on the CPU is the one device: capped to 1
    capped = fleet_region_envelopes_device(stack.L, stack.U, shards=8,
                                           device="cpu")
    for a, b in zip(one, capped):
        np.testing.assert_array_equal(a, b)
    spaces = fleet.fleet_region_spaces_device(stack, shards=8, device="cpu",
                                              devices=["cpu"] * 8)
    for i, (k, b, r) in enumerate(pairs):
        jl, ju = jget_spec(k, b).region_bounds(r)
        np.testing.assert_array_equal(jl, bounds[i][0])
        exact = jbatched.region_spaces(jl, ju)
        assert [s.feasible for s in spaces[i]] == \
            [s.feasible for s in exact], i
