"""End-to-end training on the PyTorch port: Mamba2-130M on the synthetic
pipeline with checkpointing and table-backed numerics (twin of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py                           # full 130M on the card
    PYTHONPATH=src python examples/torch_train_lm.py --smoke --steps 20 --device cpu

``--numerics interp`` routes every softplus / exp / SiLU / rsqrt of the
SSD recurrence through the paper's certified tables (the unfused glue
around the ``library_eval`` kernel on a card).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.train.step import StepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--numerics", choices=["exact", "interp"],
                    default="exact")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args = ap.parse_args(argv)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    cfg = cfg.replace(numerics=args.numerics)
    tc = TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50,
        log_every=5, seq_len=args.seq_len, global_batch=args.global_batch,
        step=StepConfig(microbatches=args.microbatches, peak_lr=6e-4,
                        warmup=min(50, args.steps // 5 + 1),
                        total_steps=args.steps),
    )
    trainer = Trainer(cfg, tc, device=args.device)
    if trainer.start_step:
        print(f"resuming from step {trainer.start_step}")
    hist = trainer.run()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    med = sorted(t["wall_s"] for t in hist)[len(hist) // 2]
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(hist)} steps "
          f"({med*1e3:.0f} ms/step median, numerics={args.numerics})")
    if trainer.stragglers:
        print(f"straggler steps: {trainer.stragglers}")
    return hist


if __name__ == "__main__":
    main()
