#!/usr/bin/env python3
"""Time the served MoE families' decode tick on one CUDA card.

    python3 tools/moe_tick_ms.py [--src DIR] [--label NAME] [--arch A,B]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two trees (a parent commit unpacked with ``git archive`` and the change) can
be timed in one call on one card, in turns. For each arch it serves the
full-width model at ``chip_smoke.py``'s depth (DeepSeekMoE-16B at
``DEEPSEEK_LAYERS`` layers, Mixtral-8x22B at ``MIXTRAL_LAYERS`` with its
4096-token window as the cache, Jamba-v0.1 at ``JAMBA_LAYERS``), bf16
random weights from seed 0, on the default library under interp-fused
numerics, through a graph engine, and times its tick at 4 live slots with
``chip_smoke.tick_profile`` (wall ms per step on the host clock, device ms
per step from torch.profiler): ``chip_smoke.py``'s §5 figures. The last
line is one JSON object.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("deepseek_moe_16b", "mixtral_8x22b", "jamba_v0_1_52b")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--arch", default=",".join(ARCHS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("moe_tick_ms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.api.library import InterpLibrary
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = InterpLibrary.default_library(dev)
    runs = {"deepseek_moe_16b": (cs.DEEPSEEK_LAYERS, cs.CACHE_LEN,
                                 cs.TICK_PROMPTS),
            "mixtral_8x22b": (cs.MIXTRAL_LAYERS, 4096, cs.MIXTRAL_TICK),
            "jamba_v0_1_52b": (cs.JAMBA_LAYERS, cs.CACHE_LEN, cs.SSM_TICK)}
    out = {"label": args.label, "src": args.src, "card": card, "runs": {}}
    for arch in args.arch.split(","):
        layers, cache_len, lengths = runs[arch]
        cfg = get_config(arch).replace(n_layers=layers,
                                       numerics="interp-fused")
        params = tf.init_params(cfg, seed=0, device=dev)
        eng = ServeEngine(cfg, params, slots=cs.SLOTS, cache_len=cache_len,
                          library=lib, horizon=cs.HORIZON, graph=True,
                          device=dev)
        res = cs.tick_profile(eng, cfg, lengths=lengths)
        res.pop("profile")
        out["runs"][arch] = dict(layers=layers, **res)
        print(f"{args.label} {arch} ({layers} layers): wall "
              f"{res['wall_ms_per_step']:.3f} ms / step, device "
              f"{cs._ms(res['device_ms_per_step'])} ms / step, busy "
              f"{cs._share(res['busy_share'])}", flush=True)
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
