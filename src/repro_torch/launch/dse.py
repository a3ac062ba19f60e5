"""DSE launcher CLI: persistent, resumable Pareto studies (twin of
``repro/launch/dse.py``; the same subcommands, flags and exit codes, plus
``--device``, default ``cuda``: ``--device cpu`` runs the Explorers, the
segmenter and the serve probe on the CPU, through the kernels' plain
versions).

    PYTHONPATH=src python -m repro_torch.launch.dse run    --study $TMPDIR/study6 --preset smoke
    PYTHONPATH=src python -m repro_torch.launch.dse resume --study $TMPDIR/study6
    PYTHONPATH=src python -m repro_torch.launch.dse report --study $TMPDIR/study6
    PYTHONPATH=src python -m repro_torch.launch.dse check  --study $TMPDIR/study6 \\
        --against artifacts/dse/FRONTIER_6.json

``run`` creates (or extends) the study and evaluates every un-journaled
trial; ``resume`` is ``run`` restricted to an existing study dir (space,
probe mode and seed come from its ``study.json``) — with ``--assert-no-exec``
it exits nonzero if any trial had to be executed, which is how CI proves
the resume path replays instead of recomputing. ``--write-frontier`` emits
``frontier.json`` even when the space is only partially journaled (the
committed prefix studies rely on this). ``report`` prints the frontier;
``check`` compares the study's frontier against a committed artifact and
exits 1 on regression. ``--emit-bench`` folds the summary row into the
port's own snapshot ``artifacts/bench/BENCH_6_torch.json`` (untracked; the
committed ``BENCH_6.json`` is the reference's).

``plan`` runs the budget-driven per-layer numerics assigner against the
committed frontiers on ``--device`` and writes the resulting
:class:`repro_torch.plan.NumericsPlan` snapshot:

    PYTHONPATH=src python -m repro_torch.launch.dse plan --arch yi_6b --smoke \\
        --budget 0.05 --save-plan $TMPDIR/yi_6b_plan.json

A study directory written by either package resumes in the other; replay
the committed ``artifacts/dse/study9`` from a copy, since ``resume``
appends to the journal and rewrites ``frontier.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.dse import (Study, compare_frontiers, load_frontier,
                             update_snapshot)
from repro_torch.dse.space import PRESETS, SearchSpace
from repro_torch.dse.study import FRONTIER_FILE

BENCH_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "bench"
# the port's own snapshot: BENCH_6.json is the reference's committed one
BENCH_SNAPSHOT = "BENCH_6_torch.json"


def _load_space(args) -> SearchSpace | None:
    if getattr(args, "space_json", None):
        return SearchSpace.from_dict(
            json.loads(pathlib.Path(args.space_json).read_text()))
    if getattr(args, "preset", None):
        return PRESETS[args.preset]()
    return None


def _print_summary(study: Study) -> dict:
    row = study.summary()
    print(f"study {row['study']}: {row['trials_recorded']}/"
          f"{row['trials_total']} trials recorded "
          f"({row['trials_infeasible']} infeasible) — this run executed "
          f"{row['executed_this_run']}, replayed {row['replayed_this_run']}; "
          f"serve probes {row['probe_runs']} run / "
          f"{row['probe_cache_hits']} cached")
    for target, n in row["frontier_points"].items():
        print(f"  frontier[{target}]: {n} points")
    return row


def _emit_bench(row: dict) -> None:
    path = BENCH_DIR / BENCH_SNAPSHOT
    update_snapshot(path, {"dse_summary": [row]}, seed=row.get("seed"))
    print(f"folded summary into {path}")


def cmd_run(args, resume_only: bool = False) -> int:
    space = None if resume_only else _load_space(args)
    root = pathlib.Path(args.study)
    if resume_only and not (root / "study.json").exists():
        print(f"no study at {root} (run `dse run` first)", file=sys.stderr)
        return 2
    with Study(root, space, measure=getattr(args, "measure", None),
               seed=getattr(args, "seed", None),
               device=args.device) as study:
        records = study.run(max_trials=args.max_trials, compact=args.compact)
        if args.write_frontier:
            print(f"frontier -> {study.write_frontier(records)}")
        row = _print_summary(study)
        if args.emit_bench:
            _emit_bench({**row, "seed": study.seed})
        if getattr(args, "assert_no_exec", False) and row["executed_this_run"]:
            print(f"RESUME REGRESSION: {row['executed_this_run']} trials "
                  f"re-executed (expected 0)", file=sys.stderr)
            return 1
    return 0


def cmd_report(args) -> int:
    root = pathlib.Path(args.study)
    front = load_frontier(root / FRONTIER_FILE)
    names = front["objectives"]
    print(f"objectives: {names}  "
          f"(trials: {front['trials']['completed']} completed, "
          f"{front['trials']['infeasible']} infeasible)")
    for target, pts in front["groups"].items():
        print(f"\n## {target} ({len(pts)} frontier points)\n")
        cols = ["kind", "R", "degree", "fused", "batch"] + list(names)
        print("| " + " | ".join(cols) + " |")
        print("|" + "---|" * len(cols))
        for pt in pts:
            p = pt["params"]
            row = [p["kind"], p["lookup_bits"], pt["metrics"].get("degree"),
                   p["fused"], p["batch"]]
            row += [f"{v:.4g}" for v in pt["objectives"]]
            print("| " + " | ".join(str(v) for v in row) + " |")
    return 0


def cmd_check(args) -> int:
    fresh_path = pathlib.Path(args.study) / FRONTIER_FILE
    if not fresh_path.exists():
        print(f"no frontier at {fresh_path} — run the study to completion "
              f"first", file=sys.stderr)
        return 2
    fresh = load_frontier(fresh_path)
    committed = load_frontier(args.against)
    problems = compare_frontiers(fresh, committed)
    if problems:
        print(f"FRONTIER REGRESSION vs {args.against}:", file=sys.stderr)
        for p in problems:
            print(f"  - {p}", file=sys.stderr)
        return 1
    n = sum(len(v) for v in committed["groups"].values())
    print(f"frontier check OK: all {n} committed points attained")
    return 0


def cmd_plan(args) -> int:
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.plan import save_plan
    from repro_torch.plan.assign import auto_plan

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    report = auto_plan(cfg, error_budget=args.budget, target=args.target,
                       verify=not args.no_verify, seed=args.seed,
                       calibrate=args.calibrate, device=args.device)
    plan = report.plan
    print(f"plan[{report.arch}]: budget {report.error_budget:.3g} -> "
          f"predicted {report.predicted_error:.3g}"
          + (f", measured {report.measured_error:.3g}"
             if report.measured_error is not None else "")
          + f"; slots {list(plan.slot_keys())}"
          + (f", downgraded {list(report.flipped)}" if report.flipped else ""))
    kind = "measured" if report.calibration is not None else "modeled"
    print(f"  {kind} decode: {report.modeled_tokens_per_s:.1f} tok/s vs "
          f"{report.exact_tokens_per_s:.1f} all-exact "
          f"({report.speedup:.3f}x)")
    if args.save_plan:
        save_plan(args.save_plan, plan, seed=args.seed,
                  meta_extra={"arch": args.arch, "smoke": args.smoke,
                              "report": report.to_dict()})
        print(f"saved plan -> {args.save_plan}")
    if (report.measured_error is not None
            and report.measured_error > args.budget):
        print(f"PLAN ERROR BUDGET VIOLATED: {report.measured_error:.3g} > "
              f"{args.budget:.3g}", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dse")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, with_space: bool):
        p.add_argument("--study", required=True, help="study directory")
        p.add_argument("--max-trials", type=int, default=None)
        p.add_argument("--compact", action="store_true",
                       help="fold the journal into snapshot.json afterwards")
        p.add_argument("--emit-bench", action="store_true",
                       help=f"fold a summary row into "
                            f"artifacts/bench/{BENCH_SNAPSHOT}")
        p.add_argument("--device", default="cuda",
                       help="device of the Explorers and the serve probe")
        p.add_argument("--write-frontier", action="store_true",
                       help="emit frontier.json even if the space is only "
                            "partially journaled")
        if with_space:
            p.add_argument("--preset", choices=sorted(PRESETS),
                           default="smoke")
            p.add_argument("--space-json", default=None,
                           help="SearchSpace JSON file (overrides --preset)")
            p.add_argument("--measure", choices=("modeled", "wall", "none"),
                           default=None)
            p.add_argument("--seed", type=int, default=None)

    p_run = sub.add_parser("run", help="create/extend a study")
    common(p_run, with_space=True)

    p_res = sub.add_parser("resume", help="continue an existing study")
    common(p_res, with_space=False)
    p_res.add_argument("--assert-no-exec", action="store_true",
                       help="fail if any trial had to be (re-)executed")

    p_rep = sub.add_parser("report", help="print the frontier tables")
    p_rep.add_argument("--study", required=True)

    p_chk = sub.add_parser("check",
                           help="regression-check vs a committed frontier")
    p_chk.add_argument("--study", required=True)
    p_chk.add_argument("--against", required=True,
                       help="committed frontier artifact path")

    p_pln = sub.add_parser("plan", help="budget-driven per-layer numerics "
                                        "assignment")
    from repro_torch.configs.base import ARCH_IDS
    p_pln.add_argument("--arch", choices=ARCH_IDS, required=True)
    p_pln.add_argument("--smoke", action="store_true")
    p_pln.add_argument("--budget", type=float, default=0.05,
                       help="whole-model relative output-error bound")
    p_pln.add_argument("--target", choices=("asic", "fpga-lut", "pallas-tpu"),
                       default="asic",
                       help="frontier cost group the slots are picked from")
    p_pln.add_argument("--save-plan", default=None,
                       help="write the NumericsPlan snapshot here")
    p_pln.add_argument("--no-verify", action="store_true",
                       help="skip the measured end-to-end error check "
                            "(predicted budget only; no table compilation)")
    p_pln.add_argument("--calibrate", action="store_true",
                       help="score throughput from wall clock measured on "
                            "AOT-warmed fused ticks instead of the modeled "
                            "constants (machine-dependent; stored in the "
                            "snapshot under report.calibration)")
    p_pln.add_argument("--seed", type=int, default=0)
    p_pln.add_argument("--device", default="cuda")

    args = ap.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "resume":
        return cmd_run(args, resume_only=True)
    if args.cmd == "report":
        return cmd_report(args)
    if args.cmd == "plan":
        return cmd_plan(args)
    return cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())
