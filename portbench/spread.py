#!/usr/bin/env python3
"""Measure a cell's run-to-run spread, from which its bounds are set.

    python3 portbench/spread.py --workload <cell> --runs 6 --sets 2 --seconds 15

Runs ``run.py`` as a new process for each run: ``--sets`` sets of
``--runs`` runs, every set on the same seeds (``--first-seed`` on), then
``--traced`` runs with ``--trace 1`` on further seeds. Prints each run's
result line and, per end-to-end metric, each set's median and spread: the
distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median. Not part of a
benchmark run.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        workload, "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)],
                       capture_output=True, text=True)
    tail = p.stderr.strip().splitlines()[-4:]
    line = (json.loads(p.stdout.strip().splitlines()[-1])
            if p.returncode == 0 and p.stdout.strip() else None)
    return {"seed": seed, "trace": trace, "rc": p.returncode,
            "result": line, "stderr_tail": tail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--traced", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--first-seed", type=int, default=2_200_000_003)
    args = ap.parse_args(argv)
    seeds = [args.first_seed + 104_729 * i for i in range(args.runs)]
    sets = []
    for _ in range(args.sets):
        rows = [one(args.workload, s, args.seconds, 0) for s in seeds]
        for r in rows:
            print(json.dumps(r), flush=True)
        sets.append(rows)
    for i in range(args.traced):
        print(json.dumps(one(args.workload, seeds[-1] + 7 + i, args.seconds,
                             1)), flush=True)
    summary = {"workload": args.workload, "sets": []}
    for rows in sets:
        got = [r["result"] for r in rows if r["result"]]
        names = got[0]["metrics"] if got else {}
        summary["sets"].append({
            "correct": sum(bool(g["correct"]) for g in got),
            "runs": len(rows),
            "metrics": {m: {"median": statistics.median(v),
                            "spread": spread(v), "values": v}
                        for m in names
                        for v in [[g["metrics"][m]["value"] for g in got]]
                        if len(v) >= 2}})
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
