#!/usr/bin/env python3
"""Find an open-loop cell's knee: the highest arrival rate it holds
without a growing backlog.

    python3 portbench/sweep.py --workload <cell> --rates 4 6 8 10 12 14

One engine serves every rate in turn (drained between them). At each rate
the loop runs the cell's warm-up and a ``--seconds`` window; the line
gives the requests due and admitted in the window, the queue left at its
close, and the time to first token. A rate holds when the window admits at
least 0.95 of what fell due in it and leaves fewer requests queued than
the engine has slots. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import run as R  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=2_000_000_011)
    args = ap.parse_args(argv)
    R.prepare_env()
    import torch

    from portbench import derive, stats

    _, cell, cfg = R.load_cell(args.workload)
    tree, eng = R.build(cell, cfg, args.seed, "cuda")
    R.warm(eng, cell, cfg["vocab_size"])
    held = []
    for rate in args.rates:
        c = dict(cell, traffic=dict(cell["traffic"], rate=rate))
        run = R.serve(eng, c, cfg, args.seed, args.seconds)
        w = run["window"]
        due = [r for r in run["records"] if stats.inside(r["due"], w)]
        admitted = len(derive.admissions(run, derive.window_steps(run)))
        queued = len(eng.queue)
        tt = stats.ttfts(run["records"], w)
        ok = admitted >= 0.95 * len(due) and queued < cell["engine"]["slots"]
        if ok:
            held.append(rate)
        print(json.dumps({
            "rate": rate, "due": len(due), "admitted": admitted,
            "queued_at_close": queued, "holds": ok,
            "ttft_p50_ms": stats.percentile(tt, 50) * 1e3,
            "ttft_p95_ms": stats.percentile(tt, 95) * 1e3,
            "itl_p95_ms": stats.percentile(
                stats.itls(run["records"], w), 95) * 1e3,
            "tokens_per_s": stats.tokens_per_s(run["records"], w)}),
            flush=True)
        R.drain(eng)
    print(json.dumps({"workload": args.workload,
                      "card": torch.cuda.get_device_name(0),
                      "knee": max(held) if held else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
