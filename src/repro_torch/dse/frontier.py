"""Frontier artifact: build, save, and regression-compare Pareto fronts
(twin of ``repro/dse/frontier.py``: the same bytes outside ``meta``).

The frontier is grouped **per target**: area/delay units are a target's own
(NAND2-eq/FO4 for asic, LUTs/levels for fpga-lut, VMEM bytes/product bits
for pallas-tpu), so cross-target domination would compare incommensurable
units. Within a group, every completed trial's objective vector — built by
:class:`repro_torch.dse.study.Study` as ``(area, delay, -accuracy_margin,
-tokens_per_s)``, all minimized — competes, and the non-dominated set (via
:func:`repro_torch.core.pareto.pareto_indices`, the same code the per-spec
R-sweep frontier uses) is serialized with deterministic JSON so the
artifact is byte-reproducible.

``compare_frontiers`` is the regression oracle: the fresh study must
dominate-or-match every committed frontier point. New points beyond the
committed front are improvements, not errors; a committed point no fresh
trial can match means the stack lost ground and ``launch/dse.py check``
exits nonzero.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Iterable

from repro_torch.core.pareto import dominates, pareto_indices

FRONTIER_SCHEMA = 1


def build_frontier(records: Iterable, objectives: list[str]) -> dict[str, Any]:
    """Per-target Pareto groups from completed :class:`TrialRecord`s.

    ``records`` may be the dict ``StudyStore.load`` returns or any iterable
    of records; infeasible trials carry no objective vector and only count
    toward the totals.
    """
    recs = list(records.values() if isinstance(records, dict) else records)
    by_target: dict[str, list] = {}
    infeasible = 0
    for r in recs:
        if not r.ok or r.objectives is None:
            infeasible += 1
            continue
        if len(r.objectives) != len(objectives):
            raise ValueError(
                f"record {r.params.key} has {len(r.objectives)} objectives, "
                f"study defines {len(objectives)}")
        by_target.setdefault(r.params.target, []).append(r)
    groups: dict[str, list[dict[str, Any]]] = {}
    for target in sorted(by_target):
        grp = by_target[target]
        idx = pareto_indices([r.objectives for r in grp])
        groups[target] = [{
            "params": grp[i].params.to_dict(),
            "metrics": grp[i].metrics,
            "objectives": grp[i].objectives,
        } for i in idx]
    return {
        "schema": FRONTIER_SCHEMA,
        "objectives": list(objectives),
        "trials": {"completed": len(recs) - infeasible,
                   "infeasible": infeasible},
        "groups": groups,
    }


def save_frontier(path: str | pathlib.Path, frontier: dict[str, Any],
                  meta: dict[str, Any] | None = None) -> pathlib.Path:
    """Write the artifact deterministically (sorted keys, tmp + rename).

    ``meta`` must itself be deterministic for the byte-identity contract —
    use ``run_meta(stamp_time=False)``.
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = dict(frontier)
    if meta is not None:
        doc["meta"] = meta
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps(doc, indent=1, sort_keys=True))
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)
    return path


def load_frontier(path: str | pathlib.Path) -> dict[str, Any]:
    doc = json.loads(pathlib.Path(path).read_text())
    if doc.get("schema") != FRONTIER_SCHEMA:
        raise ValueError(f"{path}: frontier schema {doc.get('schema')!r} "
                         f"!= {FRONTIER_SCHEMA}")
    return doc


def _param_axes(doc: dict[str, Any]) -> set[str]:
    """Union of trial-parameter field names across a frontier's points."""
    axes: set[str] = set()
    for pts in doc.get("groups", {}).values():
        for p in pts:
            axes.update(p.get("params", {}))
    return axes


def compare_frontiers(fresh: dict[str, Any], committed: dict[str, Any]
                      ) -> list[str]:
    """Regressions of ``fresh`` against ``committed`` (empty = healthy).

    A committed frontier point regresses when no fresh point in the same
    target group weakly dominates its objective vector. Meta blocks and
    extra fresh points are ignored — the committed artifact is a floor,
    not an exact expectation. Trial-parameter axes may *grow*: a fresh
    study whose params are a superset of the committed ones (a new
    TrialParams field with a default, e.g. ``segmentation``) compares
    cleanly against an older artifact; only a *vanished* committed axis is
    flagged, since the fresh study can then no longer express the
    committed points.
    """
    problems: list[str] = []
    if fresh.get("objectives") != committed.get("objectives"):
        return [f"objective axes changed: fresh {fresh.get('objectives')} "
                f"vs committed {committed.get('objectives')} — "
                f"regenerate the committed artifact"]
    lost_axes = _param_axes(committed) - _param_axes(fresh)
    if lost_axes and fresh.get("groups"):
        return [f"trial axes {sorted(lost_axes)} present in the committed "
                f"frontier are missing from the fresh study — the fresh "
                f"study cannot express the committed points"]
    for target, committed_pts in committed.get("groups", {}).items():
        fresh_pts = fresh.get("groups", {}).get(target)
        if not fresh_pts:
            problems.append(f"[{target}] group vanished from the fresh study")
            continue
        for c in committed_pts:
            if not any(dominates(f["objectives"], c["objectives"])
                       for f in fresh_pts):
                problems.append(
                    f"[{target}] committed point {c['objectives']} "
                    f"(params {c['params'].get('kind')}/R"
                    f"{c['params'].get('lookup_bits')}) is no longer "
                    f"attained by any fresh frontier point")
    return problems
