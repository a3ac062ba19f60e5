#!/usr/bin/env python3
"""Probe the exact train step of Yi-6B at full width on one CUDA card.

    python3 tools/train_lr_probe.py [--out chiprun_out/train_lr_probe.json]

The model and data are ``chip_smoke.py``'s ``train_phase`` cut: Yi-6B at 8
of 32 layers, 4 x 2048 tokens a step in 2 microbatches, ``remat="block"``,
seed-0 weights and batches, exact numerics. The probe asks whether the loss
spikes seen at a peak learning rate of 1e-4 come from the step or from
Adam's first steps on a wide random model:

1. ``grad``: with float32 parameters, the central difference of the loss
   along the unit gradient, (L(w + e g/|g|) - L(w - e g/|g|)) / 2e, against
   |g| (equal if the step differentiates its own loss).
2. ``batch_loss0``: the seed-0 model's loss on each trained batch and on a
   held-out one (batch 100).
3. ``runs``: loss, held-out loss (batch 100, before each update), grad_norm
   and lr per step for several (peak lr, warmup) settings of the port's
   ``make_train_step``, and for ``torch.optim.AdamW`` (same betas, eps,
   decay on rank >= 2 leaves, global-norm clip, schedule and float32
   master) as an independent update on the same gradients' path.

Prints the card's name and power limit and a line per run; the last line
is one JSON object, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYERS, SEQ, BATCH, MICRO, HELD = 8, 2048, 4, 2, 100
# (label, optimizer, peak lr, warmup, steps, param dtype)
RUNS = (("port 2e-5 w2", "port", 2e-5, 2, 6, "bfloat16"),
        ("port 1e-4 w2", "port", 1e-4, 2, 6, "bfloat16"),
        ("torch.optim.AdamW 1e-4 w2", "torch", 1e-4, 2, 6, "bfloat16"),
        ("port 1e-4 w20", "port", 1e-4, 20, 12, "bfloat16"),
        ("port 1e-4 w2 float32", "port", 1e-4, 2, 6, "float32"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "train_lr_probe.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_lr_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.data import dataset_for
    from repro_torch.numerics.ops import get_numerics
    from repro_torch.optim import cosine_schedule, global_norm
    from repro_torch.train import (StepConfig, make_eval_step,
                                   make_train_step, train_state_init)
    from repro_torch.train.step import batch_to, loss_and_grads
    from repro_torch.util.tree import tree_leaves, tree_map, unflatten_like

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("yi_6b").replace(n_layers=LAYERS, remat="block")
    data = dataset_for(cfg, SEQ, BATCH, seed=0)
    numerics = get_numerics(cfg, None)
    out: dict = {"card": smi, "torch": torch.__version__}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # 1. the gradient against the loss it differentiates, float32 weights
    fcfg = cfg.replace(param_dtype="float32")
    params = train_state_init(fcfg, StepConfig(), seed=0, device=dev).params
    b0 = {k: v[:BATCH // MICRO] for k, v in
          batch_to(data.batch_at(0), dev).items()}
    loss, _, grads = loss_and_grads(params, b0, fcfg, numerics, 1)
    gn = float(global_norm(grads))
    ev = make_eval_step(fcfg)
    checks = []
    for e in (1e-2, 3e-3):
        lp, lm = (float(ev(tree_map(lambda w, g, s=s: w + s * (e / gn) * g,
                                    params, grads), b0)["loss"])
                  for s in (1.0, -1.0))
        checks.append({"eps": e, "loss_plus": lp, "loss_minus": lm,
                       "slope": (lp - lm) / (2 * e),
                       "slope_over_norm": (lp - lm) / (2 * e) / gn})
    out["grad"] = {"loss": float(loss), "grad_norm": gn, "checks": checks}
    print(f"grad [{smi}]: loss {float(loss)!r}, |g| {gn!r}; "
          + "; ".join(f"eps {c['eps']}: slope / |g| "
                      f"{c['slope_over_norm']!r}" for c in checks),
          flush=True)
    del params, grads
    free()

    # 2. the seed-0 model on each batch the runs train on, and the held one
    params = train_state_init(cfg, StepConfig(), seed=0, device=dev).params
    ev = make_eval_step(cfg)
    out["batch_loss0"] = {str(i): float(ev(params, data.batch_at(i))["loss"])
                          for i in (*range(12), HELD)}
    print(f"batch_loss0 [{smi}]: {out['batch_loss0']}", flush=True)
    del params
    free()

    # 3. trajectories
    held = data.batch_at(HELD)
    out["runs"] = []
    for label, opt_name, peak, warmup, steps, dtype in RUNS:
        c = cfg.replace(param_dtype=dtype)
        sc = StepConfig(microbatches=MICRO, peak_lr=peak, warmup=warmup,
                        total_steps=steps)
        ev = make_eval_step(c)
        state = train_state_init(c, sc, seed=0, device=dev)
        hist = []
        if opt_name == "port":
            step = make_train_step(c, sc, donate=True)
            for i in range(steps):
                h = float(ev(state.params, held)["loss"])
                state, m = step(state, data.batch_at(i), i)
                hist.append({"loss": float(m["loss"]), "held": h,
                             "grad_norm": float(m["grad_norm"]),
                             "lr": float(m["lr"])})
            del state, step
        else:
            params = state.params
            masters = tree_leaves(state.opt.master)
            del state
            opt = torch.optim.AdamW(
                [{"params": [w for w in masters if w.dim() >= 2],
                  "weight_decay": 0.1},
                 {"params": [w for w in masters if w.dim() < 2],
                  "weight_decay": 0.0}],
                lr=0.0, betas=(0.9, 0.95), eps=1e-8)
            for i in range(steps):
                h = float(ev(params, held)["loss"])
                loss, _, grads = loss_and_grads(
                    params, batch_to(data.batch_at(i), dev), c, numerics,
                    MICRO)
                gs = [g.to(torch.float32) for g in tree_leaves(grads)]
                del grads
                norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
                scale = torch.clamp(1.0 / norm, max=1.0)
                for w, g in zip(masters, gs):
                    w.grad = g * scale
                del gs
                lr = float(cosine_schedule(i, peak_lr=peak, warmup=warmup,
                                           total=steps))
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.step()
                opt.zero_grad(set_to_none=True)
                params = unflatten_like(params, [w.to(torch.bfloat16)
                                                 for w in masters])
                hist.append({"loss": float(loss), "held": h,
                             "grad_norm": float(norm), "lr": lr})
            del params, masters, opt
        free()
        run = {"label": label, "peak_lr": peak, "warmup": warmup,
               "steps": steps, "param_dtype": dtype, "hist": hist}
        out["runs"].append(run)
        print(f"run {label} [{smi}]: loss "
              f"{[round(h['loss'], 4) for h in hist]}, held "
              f"{[round(h['held'], 4) for h in hist]}, grad_norm "
              f"{[round(h['grad_norm'], 2) for h in hist]}", flush=True)

    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
