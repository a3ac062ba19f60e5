#!/usr/bin/env python3
"""Time the port's table softmax at its main-path shapes on one CUDA card.

    python3 tools/softmax_graph_ms.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two trees (a parent commit unpacked with ``git archive`` and the change) can
be timed in one call on one card, in turns. For each shape it prints the
``graph_ms`` of ``approx_softmax_library`` on the default library and on
one whose exp2neg and recip slots are segmented, of ``approx_softmax_fused``
on the default 12-bit designs, and of ``torch.softmax`` on the same
tensor, each timed by ``chip_smoke.py``'s ``graph_ms`` (CUDA events around
the replay of one CUDA graph of 50 captured calls). The last line is one
JSON object.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = (((4, 64), "float32"), ((511, 64), "float32"),
          ((8, 4096), "bfloat16"), ((37, 1000), "bfloat16"),
          ((16384, 512), "float32"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("softmax_graph_ms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    from chip_smoke import graph_ms
    from repro_torch.api import Explorer, ExploreConfig, spec_for
    from repro_torch.api.library import DEFAULT_LIBRARY_KINDS, InterpLibrary
    from repro_torch.kernels.softmax.ops import (approx_softmax_fused,
                                                 approx_softmax_library)
    from repro_torch.segment import explore_segmented

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    uni = InterpLibrary.default_library(dev)
    designs = {k: explore_segmented(spec_for(k), max_depth=6,
                                    engine="batched", device="cpu")
               for k in ("exp2neg", "recip")}
    with tempfile.TemporaryDirectory() as tmp:
        gen = Explorer(ExploreConfig(device="cpu", cache_dir=tmp))
        r6 = {k: gen.get_table(k) for k in ("exp2neg", "recip")}
        seg = InterpLibrary.from_designs(
            [designs[k] if k in designs else gen.get_table(k)
             for k in DEFAULT_LIBRARY_KINDS], DEFAULT_LIBRARY_KINDS,
            device=dev)
    g = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for shape, dname in SHAPES:
        x = (torch.randn(shape, device=dev, generator=g) * 4).to(
            getattr(torch, dname))
        row = dict(shape=list(shape), dtype=dname,
                   lib=graph_ms(lambda: approx_softmax_library(x, uni))[0],
                   seg=graph_ms(lambda: approx_softmax_library(x, seg))[0],
                   tab=graph_ms(lambda: approx_softmax_fused(
                       x, r6["exp2neg"], r6["recip"]))[0],
                   torch_softmax=graph_ms(lambda: torch.softmax(x, -1))[0])
        print(f"{args.label} {shape} {dname}: softmax_lib "
              f"{row['lib'] * 1e3:.3f} us, segmented {row['seg'] * 1e3:.3f}"
              f" us, softmax_tab {row['tab'] * 1e3:.3f} us, torch.softmax "
              f"{row['torch_softmax'] * 1e3:.3f} us")
        rows.append(row)
    print(json.dumps({"label": args.label, "device": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
