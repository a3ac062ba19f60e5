"""Serving launcher: continuous-batching greedy decoding on random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --numerics interp --requests 6 --slots 4 --prompt-len 64 --max-new 16

runs the full-width model on the CUDA card; ``--arch`` takes the ids of
``configs.base.ARCH_IDS``: ``yi_6b``, ``deepseek_moe_16b``,
``minicpm3_4b`` (MLA), ``mixtral_8x22b`` (sliding-window MoE: a
``--cache-len`` of at least its 4096-token window), ``qwen1_5_110b`` (QKV
bias), ``minitron_8b`` (squared ReLU), ``mamba2_130m`` (the Mamba2 SSD
mixer), ``jamba_v0_1_52b`` (the attention / Mamba / MoE hybrid; the
whole model does not fit one card) and ``internvl2_2b`` (served as a text
decoder: a request carries no patches, as in the reference);
``whisper_tiny`` exits with the engine's refusal (a request carries no
encoder frames). An SSM config's prompt longer than its
SSD chunk (256 tokens) must be a whole number of chunks, as in the
reference. ``--smoke --device cpu`` runs
the reduced config on the CPU through the kernels' plain versions. The flags and defaults are the
reference launcher's: ``--numerics exact|interp`` (``interp-fused`` names
the same engine: interp numerics always serve through the library-bound
kernels here), default the config's own numerics; 8 requests of 12 new
tokens. ``--library PATH`` serves a saved :class:`InterpLibrary` (v1 or v2,
e.g. one from ``Explorer.compile_segmented()``) instead of the default one,
``--save-library PATH`` writes the library the engine serves; either
implies interp numerics and is refused with ``--numerics exact``.

Per-layer numerics, as the reference's flags: ``--plan PATH`` serves
under a saved :class:`repro_torch.plan.NumericsPlan` (the snapshot
envelope either package's ``save_plan`` writes: one backend and library
slot per layer x op site; one library per slot is compiled at
construction), ``--save-plan PATH`` writes the plan the engine serves
(with ``--numerics``, a uniform plan to edit later).

The serving tier, as the reference's flags: ``--aot-buckets B1,B2,...``
(or ``default``: the built-in table clipped to ``--cache-len``) prepares a
packed admission per (bucket, pack) at construction, one CUDA graph each
on the card; ``--max-pack N`` bounds the packed groups; ``--async-host``
moves detokenize and journal writes to a host worker thread.

The reference's robustness flags, with its defaults: ``--serial`` (the
per-token oracle instead of the fused tick), ``--deadline-ms N`` (a TTL per
request; expired work retires with ``deadline_exceeded``), ``--max-queue
N`` (admission bound; overflow is rejected with ``queue_full``),
``--journal PATH`` (the fsync'd admission / token journal) and ``--resume``
(with ``--journal``: rebuild the engine from that journal after a crash).
``--eager`` is the port's own debugging switch: the fused tick runs its
Python loop on the card instead of replaying CUDA graphs.

``--mesh DxT`` (bare ``N`` means ``Nx1``) serves on a ``(data, tp)`` mesh,
one process per rank under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``)::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch yi_6b \
        --mesh 2x1

NCCL on the cards (each rank on ``cuda:LOCAL_RANK``), gloo with
``--device cpu``; ``--dist-url`` names another rendezvous than
``torchrun``'s (``file:///path``). Every rank builds the same weights and
requests; only rank 0 prints. What the mesh writes once, rank 0 (the lead,
every coordinate 0) writes alone: ``--journal`` (only it binds the
journal; ``--resume`` reads it there and shares the replay states with the
other ranks, which need not see the file) and ``--save-library``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import INTERP_BACKENDS
from repro_torch.serve.engine import Rejected, Request, ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--horizon", type=int, default=8,
                    help="fused tick: max decode steps per dispatch")
    ap.add_argument("--serial", action="store_true",
                    help="per-op dispatch path (the oracle) instead of the "
                         "fused tick")
    ap.add_argument("--eager", action="store_true",
                    help="port-only debugging switch: run the fused tick's "
                         "loop eagerly instead of replaying CUDA graphs")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request TTL; expired requests are retired "
                         "with a structured deadline_exceeded error")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission queue bound; overflow submissions are "
                         "rejected (reason=queue_full), never buffered")
    ap.add_argument("--journal", default=None,
                    help="fsync'd serve journal (admissions + tokens); "
                         "makes the run crash-recoverable via --resume")
    ap.add_argument("--resume", action="store_true",
                    help="rebuild engine state from --journal instead of "
                         "submitting fresh requests")
    ap.add_argument("--numerics", choices=["exact", "interp", "interp-fused"],
                    default=None,
                    help="default: the config's own numerics")
    ap.add_argument("--library", default=None,
                    help="serve from this saved InterpLibrary (json/npz base)")
    ap.add_argument("--save-library", default=None,
                    help="write the library the engine serves here")
    ap.add_argument("--plan", default=None,
                    help="serve under this saved NumericsPlan snapshot "
                         "(per-layer x per-op-site numerics)")
    ap.add_argument("--save-plan", default=None,
                    help="write the served plan (from --plan, or a uniform "
                         "plan matching --numerics) as a snapshot")
    ap.add_argument("--aot-buckets", default=None, metavar="B1,B2,...",
                    help="prepare the decode tick and a packed prefill "
                         "admission per bucket at construction (CUDA "
                         "graphs on the card); 'default' uses the built-in "
                         "table clipped to --cache-len")
    ap.add_argument("--max-pack", type=int, default=4,
                    help="max prompts packed into one bucketed prefill "
                         "admission (power-of-two group sizes)")
    ap.add_argument("--async-host", action="store_true",
                    help="detokenize/journal on a background host thread "
                         "behind a bounded queue")
    ap.add_argument("--mesh", default=None, metavar="DxT",
                    help="serve on a (data, tp) mesh, e.g. 2x4 (bare N "
                         "means Nx1), one process per rank under torchrun; "
                         "needs data*tp ranks")
    ap.add_argument("--dist-url", default="env://",
                    help="rendezvous of the process group with --mesh "
                         "(default: torchrun's environment)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.resume and not args.journal:
        ap.error("--resume requires --journal")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.numerics:
        cfg = cfg.replace(numerics=args.numerics)
    if args.plan:
        from repro_torch.plan import load_plan

        plan = load_plan(args.plan)
        if plan.n_layers != cfg.n_layers:
            ap.error(f"--plan has {plan.n_layers} layers but {args.arch} "
                     f"(smoke={args.smoke}) has {cfg.n_layers}")
        cfg = cfg.replace(plan=plan)
        if args.library:
            ap.error("--plan engines compile one library per plan slot; "
                     "--library cannot override them")
    if args.library or args.save_library:
        if args.numerics == "exact":
            ap.error("--library/--save-library require interp numerics")
        if cfg.plan is None and cfg.numerics not in INTERP_BACKENDS:
            cfg = cfg.replace(numerics="interp")  # the flags imply it
    if args.save_plan:
        from repro_torch.plan import plan_for, save_plan

        served = cfg.plan if cfg.plan is not None else plan_for(cfg)
        save_plan(args.save_plan, served, seed=args.seed,
                  meta_extra={"arch": args.arch, "smoke": args.smoke})
        print(f"saved plan -> {args.save_plan}")
    buckets = None
    if args.aot_buckets:
        buckets = (True if args.aot_buckets == "default" else
                   tuple(int(b) for b in args.aot_buckets.split(",")))

    dev = resolve(args.device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import (init_from_env, make_serve_mesh,
                                             parse_mesh_spec)

        try:
            data, tp = parse_mesh_spec(args.mesh)
        except ValueError as e:
            ap.error(str(e))
        dev = init_from_env(dev, args.dist_url)
        mesh = make_serve_mesh(data, tp)
    try:
        _serve(ap, args, cfg, buckets, dev, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(ap, args, cfg, buckets, dev, mesh) -> None:
    """Build the engine, submit the requests, run; rank 0 prints."""
    lead = mesh is None or mesh.lead

    def say(*a, **k):
        if lead:
            print(*a, **k)

    library = (InterpLibrary.load(args.library, device=dev) if args.library
               else None)
    params = tf.init_params(cfg, seed=args.seed, device=dev)
    kw = dict(slots=args.slots, cache_len=args.cache_len, library=library,
              fused=not args.serial, horizon=args.horizon,
              max_queue=args.max_queue,
              deadline_s=(args.deadline_ms / 1e3
                          if args.deadline_ms is not None else None),
              aot_buckets=buckets, max_pack=args.max_pack,
              async_host=args.async_host,
              graph=False if args.eager else None, mesh=mesh, device=dev)
    try:
        if args.resume:
            eng = ServeEngine.resume(args.journal, cfg, params, **kw)
        else:
            eng = ServeEngine(cfg, params, journal=args.journal, **kw)
    except ValueError as e:  # a config or flags the engine refuses
        ap.exit(2, f"{ap.prog}: error: {e}\n")
    if args.save_library and eng.library is not None and lead:
        if isinstance(eng.library, dict):  # plan engine: one per slot
            for key, lib in sorted(eng.library.items()):
                say(f"saved library [{key}] -> "
                      f"{lib.save(f'{args.save_library}.{key}')}")
        else:
            say(f"saved library -> {eng.library.save(args.save_library)}")
    if not args.resume:
        rng = np.random.default_rng(args.seed)
        for i in range(args.requests):
            n = max(1, args.prompt_len - i % 4)
            prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            try:
                eng.submit(Request(i, prompt, max_new=args.max_new))
            except Rejected as e:
                say(f"request {i} rejected ({e.reason})")
    t0 = time.perf_counter()
    done = eng.run()
    eng.close()  # joins the host worker of --async-host
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.rid):
        say(f"request {r.rid}: {len(r.prompt)} prompt -> {r.out}")
    for r in eng.failed:
        say(f"request {r.rid} failed: {r.error}")
    n_tok = sum(len(r.out) for r in done)
    lib = eng.library
    say(json.dumps({"device": str(dev), "mesh": args.mesh,
                      "numerics": ("plan" if eng.cfg.plan is not None
                                   else eng.cfg.numerics),
                      "tokens": n_tok, "seconds": dt,
                      "rom_sha": ({k: v.rom_sha() for k, v in lib.items()}
                                  if isinstance(lib, dict)
                                  else lib and lib.rom_sha()),
                      "failed": len(eng.failed), "faults": eng.faults,
                      "stats": eng.stats}))


if __name__ == "__main__":
    main()
