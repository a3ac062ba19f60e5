#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 12 --seconds 15 [--routes 3]

For each seed the weights are drawn again in place (the engine's graphs
keep their addresses), the cell's loop runs at its own load for
``--seconds``, and the same sample a benchmark run checks is judged by the
run's own ``judge`` twice: the program's served tokens (the lower reading,
over sound runs) and the tokens the fp8 control puts first at the same
rows (the upper reading). Each is judged under the cell's limits, so the
line says whether the program passed and the control failed.

With ``--routes n`` (an MoE cell), the first ``n`` seeds also replay each
sampled request through the program's own eager prefill and decode steps,
teacher-forced on the served tokens, recording the experts every MoE
layer chose, and set them beside the reference's: the gaps of the rows
where some layer chose another top-k set than the reference, and of the
rows where none did. Prints one JSON line per seed and a summary line.
Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import run as R  # noqa: E402


def program_routes(tree: dict, cfg: dict, picked: list[dict], device,
                   pcfg=None) -> list[tuple]:
    """Per sampled request, per MoE layer, the program's expert ids of
    every row from the prompt's last on, and the share of rows at which
    the replay's greedy token is the served one."""
    import torch

    from repro_torch.api.library import InterpLibrary
    from repro_torch.models import moe as moe_mod, transformer as tf
    from repro_torch.numerics.ops import get_numerics

    pcfg = R.program_config(cfg, pcfg)
    numerics = get_numerics(pcfg, InterpLibrary.default_library(device),
                            fused=True)
    orig, seen = moe_mod.route, []

    def route(p, x, c, n):
        probs, idx, gate = orig(p, x, c, n)
        seen.append(idx[0].cpu())
        return probs, idx, gate

    moe_mod.route = route
    out = []
    try:
        with torch.no_grad():
            for r in picked:
                prompt, served = list(map(int, r["prompt"])), r["out"]
                n, cap = len(prompt), r["cap_len"]
                toks = torch.zeros(1, cap, dtype=torch.int64, device=device)
                toks[0, :n] = torch.as_tensor(prompt, device=device)
                cache_len = n + len(served)
                seen.clear()
                lg, cache = tf.prefill_padded(tree, toks, [n], pcfg,
                                              numerics, max(cache_len, cap))
                layers = [[ids[n - 1:n]] for ids in seen]
                agree = [int(lg[0, -1].argmax()) == served[0]]
                for j, t in enumerate(served[:-1]):
                    seen.clear()
                    lg, cache = tf.decode_step(
                        tree, torch.tensor([[t]], device=device),
                        torch.tensor([n + j], dtype=torch.int32,
                                     device=device), cache, pcfg, numerics)
                    for acc, ids in zip(layers, seen):
                        acc.append(ids[0:1])
                    agree.append(int(lg[0, -1].argmax()) == served[j + 1])
                out.append(([torch.cat(a) for a in layers],
                            sum(agree) / len(agree)))
    finally:
        moe_mod.route = orig
    return out


def route_flips(tree: dict, cfg: dict, picked: list[dict], device,
                pcfg=None) -> dict:
    """The gaps of the rows where the program's experts differ from the
    reference's in some layer, and of the rest."""
    import torch

    from portbench.reference import compare

    ref_routes: list = []
    found = compare.check(tree, cfg, picked, device=device,
                          routes=ref_routes)
    prog = program_routes(tree, cfg, picked, device, pcfg)
    flips = []
    for r, ref, (mine, _) in zip(picked, ref_routes, prog):
        lo = len(r["prompt"]) - 1
        row = torch.zeros(len(r["out"]), dtype=torch.bool)
        for a, b in zip(ref, mine):
            a = a[lo:].sort(-1).values
            row |= (a != b.sort(-1).values).any(-1)
        flips.append(row)
    flip = torch.cat(flips)
    g = found["gaps"]

    def part(mask):
        x = g[mask]
        return {"rows": int(x.numel()),
                "max_gap": float(x.max()) if x.numel() else None,
                "mean_gap": float(x.mean()) if x.numel() else None}

    big = g > 0.25
    return {"flipped": part(flip), "unflipped": part(~flip),
            "gap_over_0.25": int(big.sum()),
            "of_which_flipped": int((big & flip).sum()),
            "replay_agrees": [a for _, a in prog]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_007)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--routes", type=int, default=0)
    args = ap.parse_args(argv)
    R.prepare_env()
    import torch

    from portbench import weights

    _, cell, cfg = R.load_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    tree, eng = R.build(cell, cfg, seeds[0], "cuda")
    R.warm(eng, cell, cfg["vocab_size"])
    rows = []
    keys = ("max_gap", "mean_gap", "other_token_share", "rows", "correct")
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        weights.fill(tree, cfg, seed)
        run = R.serve(eng, cell, cfg, seed, args.seconds)
        picked = R.sample(run, seed)
        R.drain(eng)
        v = R.judge(tree, cfg, cell, picked, "cuda", control=True)
        row = {"seed": seed, "program": {k: v.get(k) for k in keys},
               "control": {k: v["control"].get(k) for k in keys},
               "requests": len(picked), "short_or_bad": v["short_or_bad"]}
        if i < args.routes:
            row["routes"] = route_flips(tree, cfg, picked, "cuda")
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload,
               "card": torch.cuda.get_device_name(0),
               "limits": cell["check"]["limits"],
               "program_correct": sum(r["program"]["correct"] for r in rows),
               "control_correct": sum(r["control"]["correct"] for r in rows),
               "seeds": len(rows)}
    for k in ("max_gap", "mean_gap"):
        prog = [r["program"][k] for r in rows]
        ctrl = [r["control"][k] for r in rows]
        summary[k] = {"program_max": max(prog), "program": prog,
                      "control_min": min(ctrl), "control": ctrl}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
