"""Training launcher (twin of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --smoke \
        --device cpu --steps 50 --seq-len 256 --global-batch 8 \
        [--numerics interp]

``--smoke`` takes the reduced config; without it the full config, on the
card (``--device``, default ``cuda``; ``cpu`` runs the kernels' plain
versions). The other flags and their defaults are the reference's.
``--numerics interp`` trains through the unbound interp numerics (each
table resolved through the default session, read by ``interp_eval`` on
the card). SIGTERM lets the step in flight finish, saves it and exits.
The last line of the output is one JSON object: device, arch, mesh, first
and last step, final loss, stragglers.

Under ``torchrun`` (``WORLD_SIZE`` > 1) or with ``--model-parallel N`` the
trainer runs on a ``data = world / N`` x ``model = N`` mesh
(``launch.mesh.make_host_mesh``), one process per rank: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``; ``--dist-url`` names
another rendezvous than torchrun's. Only rank 0 prints::

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch yi_6b \
        --smoke --device cpu --model-parallel 2
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import tempfile

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve
from repro_torch.train.step import StepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--numerics", choices=["exact", "interp"], default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-url", default="env://",
                    help="rendezvous of the process group on a mesh "
                         "(default: torchrun's environment)")
    return ap


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.numerics:
        cfg = cfg.replace(numerics=args.numerics)
    dev = resolve(args.device)
    mesh = None
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.model_parallel < 1 or world % args.model_parallel:
        raise ValueError(f"--model-parallel {args.model_parallel}: a data x "
                         f"model mesh needs a multiple of that many ranks, "
                         f"the world has {world} (start the ranks with "
                         f"torchrun)")
    if args.model_parallel > 1 or world > 1:
        from repro_torch.launch.mesh import init_from_env, make_host_mesh

        dev = init_from_env(dev, args.dist_url)
        mesh = make_host_mesh(args.model_parallel)
    try:
        return _train(args, cfg, dev, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, cfg, dev, mesh) -> list[dict]:
    lead = mesh is None or all(v == 0 for v in mesh.coords.values())

    def say(*a):
        if lead:
            print(*a, flush=True)

    tc = TrainerConfig(
        steps=args.steps, ckpt_dir=f"{args.ckpt_dir}/{args.arch}",
        ckpt_every=args.ckpt_every, seq_len=args.seq_len,
        global_batch=args.global_batch, seed=args.seed,
        step=StepConfig(microbatches=args.microbatches, peak_lr=args.lr,
                        warmup=args.warmup, total_steps=args.steps))
    trainer = Trainer(cfg, tc, mesh=mesh, device=dev)
    prev = signal.signal(signal.SIGTERM, lambda *_: trainer.request_stop())
    try:
        hist = trainer.run()
    finally:
        signal.signal(signal.SIGTERM, prev)
    if trainer.stragglers:
        say(f"stragglers: {trainer.stragglers[:5]}")
    if hist:
        say(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps")
    say(json.dumps({
        "device": str(dev), "arch": args.arch, "numerics": cfg.numerics,
        "mesh": None if mesh is None else mesh.shape,
        "start_step": trainer.start_step,
        "last_step": hist[-1]["step"] if hist else None,
        "final_loss": hist[-1]["loss"] if hist else None,
        "stragglers": len(trainer.stragglers)}))
    return hist


if __name__ == "__main__":
    main()
