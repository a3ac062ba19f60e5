"""The Study: a persistent, resumable sweep over the full-stack space
(twin of ``repro/dse/study.py``).

A study owns one :class:`StudyStore` (journal + snapshot under its
directory), one :class:`Explorer` session per region engine it touches,
and one :class:`ServeProbe`. ``run()`` walks the search space in its
deterministic order, *replays* every trial whose key is already journaled
(zero recomputation — the ``replayed``/``executed`` counters are the
resume contract the tests assert), batches the cache-missing trials'
envelope probes into one fleet program (``Explorer.prime_envelopes``; a
no-op under ``engine="pallas"``, whose trials launch the envelope and
``dd_max_rows`` kernels per (spec, R) on the study's device), evaluates
the remainder, and journals each verdict durably before moving on.
Killing the process at any point loses at most the in-flight trial.

Every Explorer, the segmenter of ``hier`` trials and the serve probe run
on the study's ``device`` (default ``"cuda"``; resolved through
:func:`repro_torch.device.resolve`, so a missing card raises). Journals,
``study.json`` and the frontier outside its ``meta`` block are the
reference's bytes: a study written by either package resumes in the other.

Objectives (all minimized; frontier grouped per target — see frontier.py):

  area, delay           the trial target's proxy units for the chosen
                        design at this (spec, R)
  neg_accuracy_margin   minus the worst-case slack, in output ULPs, between
                        the certified design and its §II error envelope —
                        more margin survives downstream quantization
  neg_tokens_per_s      minus the serve probe's decode throughput
                        (absent when the probe mode is "none")
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any

import numpy as np

from repro_torch.api.config import ExploreConfig
from repro_torch.api.explorer import Explorer
from repro_torch.core.funcspec import FunctionSpec
from repro_torch.core.table import TableDesign
from repro_torch.device import resolve
from repro_torch.dse.frontier import build_frontier, save_frontier
from repro_torch.dse.probe import ServeProbe
from repro_torch.dse.record import run_meta
from repro_torch.dse.space import SearchSpace
from repro_torch.dse.store import StudyStore
from repro_torch.dse.trial import TrialParams, TrialRecord

STUDY_SCHEMA = 1
STUDY_FILE = "study.json"
FRONTIER_FILE = "frontier.json"

OBJECTIVES_PROXY = ("area", "delay", "neg_accuracy_margin")
OBJECTIVES_FULL = OBJECTIVES_PROXY + ("neg_tokens_per_s",)


def accuracy_margin_ulp(design: TableDesign, spec: FunctionSpec) -> int:
    """Worst-case slack (output ULPs) between the design and its §II
    envelope: ``min over all inputs of min(y - L, U - y)``. Exhaustive and
    exact (integer arithmetic), like ``TableDesign.verify``; >= 0 for any
    verified design, and larger means the design survives more downstream
    perturbation before violating the paper's error bound."""
    lo, hi = spec.bound_arrays()
    codes = np.arange(1 << design.in_bits, dtype=np.int64)
    y = design.eval_int(codes)
    return int(np.minimum(y - lo, hi - y).min())


class Study:
    """One resumable DSE study rooted at a directory.

    Construct with a ``space`` to create (or extend) a study; construct
    with ``space=None`` to resume purely from the saved ``study.json``.
    ``measure`` (probe mode: modeled/wall/none) and ``seed`` default to
    the saved values on resume; changing the measure of an existing study
    is refused — it would change the objective axes out from under the
    journaled records. ``device`` is where the study's Explorers and its
    probe run (``explore``'s own ``device`` is replaced by it).
    """

    def __init__(self, root: str | pathlib.Path, space: SearchSpace | None = None,
                 *, measure: str | None = None, seed: int | None = None,
                 explore: ExploreConfig | None = None,
                 probe: ServeProbe | None = None, name: str | None = None,
                 device="cuda"):
        self.device = resolve(device)
        self.root = pathlib.Path(root)
        self.store = StudyStore(self.root)
        saved = self._load_study_file()
        if saved is not None:
            if measure is not None and measure != saved["measure"]:
                raise ValueError(
                    f"study {self.root} was created with measure="
                    f"{saved['measure']!r}; changing it to {measure!r} would "
                    f"change the objective axes under the journaled trials")
            measure = saved["measure"]
            seed = saved["seed"] if seed is None else seed
            if space is None:
                space = SearchSpace.from_dict(saved["space"])
            name = name or saved.get("name")
        elif space is None:
            raise ValueError(f"no study at {self.root} and no space given")
        self.space = space
        self.measure = measure or "modeled"
        self.seed = 0 if seed is None else seed
        self.name = name or self.root.name
        self.objectives = list(OBJECTIVES_PROXY if self.measure == "none"
                               else OBJECTIVES_FULL)
        self.probe = probe or ServeProbe(self.measure, seed=self.seed,
                                         device=self.device)
        self._explore_cfg = explore or ExploreConfig()
        self._explorers: dict[str, Explorer] = {}
        self._specs: dict[tuple, FunctionSpec] = {}
        self.stats = {"executed": 0, "replayed": 0, "infeasible": 0}
        if saved is None:
            self._write_study_file()

    # -- persistence of the study header -----------------------------------
    def _study_path(self) -> pathlib.Path:
        return self.root / STUDY_FILE

    def _load_study_file(self) -> dict[str, Any] | None:
        path = self._study_path()
        if not path.exists():
            return None
        doc = json.loads(path.read_text())
        if doc.get("schema") != STUDY_SCHEMA:
            raise ValueError(f"{path}: study schema {doc.get('schema')!r} "
                             f"!= {STUDY_SCHEMA}")
        return doc

    def _write_study_file(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        doc = {
            "schema": STUDY_SCHEMA,
            "name": self.name,
            "measure": self.measure,
            "seed": self.seed,
            "objectives": self.objectives,
            "space": self.space.to_dict(),
            "meta": run_meta(self.seed, extra={"device": self.device.type}),
        }
        tmp = self._study_path().with_suffix(".json.tmp")
        tmp.write_text(json.dumps(doc, indent=1, sort_keys=True))
        tmp.replace(self._study_path())

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "Study":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self.store.close()
        self.probe.close()
        for ex in self._explorers.values():
            ex.close()
        self._explorers.clear()

    # -- evaluation machinery ----------------------------------------------
    def _explorer(self, engine: str) -> Explorer:
        if engine not in self._explorers:
            cfg = dataclasses.replace(self._explore_cfg, engine=engine,
                                      device=str(self.device))
            self._explorers[engine] = Explorer(cfg)
        return self._explorers[engine]

    def _spec(self, p: TrialParams) -> FunctionSpec:
        key = (p.kind, p.bits, p.out_bits, p.ulp)
        if key not in self._specs:
            self._specs[key] = p.spec()
        return self._specs[key]

    def _evaluate(self, p: TrialParams) -> TrialRecord:
        spec = self._spec(p)
        t0 = time.perf_counter()
        if p.segmentation == "hier":
            return self._evaluate_hier(p, spec, t0)
        ex = self._explorer(p.engine)
        entry = ex.explore_r(spec, p.lookup_bits, target=p.target,
                             degree=p.degree)
        if entry is None:
            return TrialRecord(p, "infeasible",
                               timing={"eval_s": time.perf_counter() - t0})
        margin = accuracy_margin_ulp(entry.design, spec)
        metrics: dict[str, Any] = {
            "area": float(entry.area),
            "delay": float(entry.delay),
            "accuracy_margin": margin,
            "degree": entry.design.degree,
            "k": entry.report.k,
        }
        timing: dict[str, float] = {"explore_s": entry.runtime_s}
        served = self.probe.measure(p)
        wall = served.pop("wall_tokens_per_s", None)
        if wall is not None:
            timing["wall_tokens_per_s"] = wall
        retries = served.pop("probe_retries", None)
        if retries:  # wall-clock accident, not part of the metrics contract
            timing["retries"] = int(retries)
        metrics.update(served)
        objectives = [metrics["area"], metrics["delay"], -float(margin)]
        if self.measure != "none":
            objectives.append(-float(metrics["tokens_per_s"]))
        timing["eval_s"] = time.perf_counter() - t0
        return TrialRecord(p, "ok", metrics=metrics, objectives=objectives,
                           timing=timing)

    def _evaluate_hier(self, p: TrialParams, spec: FunctionSpec,
                       t0: float) -> TrialRecord:
        """Non-uniform trial: the greedy segmenter with ``lookup_bits`` as
        the depth cap, costed by the segment-aware estimator (uniform cost
        model over stored rows + the target's segment decoder)."""
        from repro_torch.segment import estimate_segmented, explore_segmented

        design = explore_segmented(spec, max_depth=p.lookup_bits,
                                   degree=p.degree, engine=p.engine,
                                   device=self.device)
        if design is None:
            return TrialRecord(p, "infeasible",
                               timing={"eval_s": time.perf_counter() - t0})
        ad = estimate_segmented(design, p.target)
        margin = accuracy_margin_ulp(design, spec)
        metrics: dict[str, Any] = {
            "area": float(ad.area),
            "delay": float(ad.delay),
            "accuracy_margin": margin,
            "degree": design.degree,
            "k": design.k,
            "rows": design.rows_used,
            "leaves": design.n_leaves,
        }
        timing: dict[str, float] = {}
        served = self.probe.measure(p)
        wall = served.pop("wall_tokens_per_s", None)
        if wall is not None:
            timing["wall_tokens_per_s"] = wall
        retries = served.pop("probe_retries", None)
        if retries:
            timing["retries"] = int(retries)
        metrics.update(served)
        objectives = [metrics["area"], metrics["delay"], -float(margin)]
        if self.measure != "none":
            objectives.append(-float(metrics["tokens_per_s"]))
        timing["eval_s"] = time.perf_counter() - t0
        return TrialRecord(p, "ok", metrics=metrics, objectives=objectives,
                           timing=timing)

    # -- the resumable loop ------------------------------------------------
    def run(self, max_trials: int | None = None,
            compact: bool = False) -> dict[str, TrialRecord]:
        """Evaluate every not-yet-journaled trial (up to ``max_trials``).

        Returns the full record map (replayed + fresh). Writes the frontier
        artifact whenever the space is fully evaluated; ``compact`` folds
        the journal into the snapshot afterwards.
        """
        records = self.store.load()
        todo: list[TrialParams] = []
        for p in self.space.trials():
            if p.key in records:
                self.stats["replayed"] += 1
            else:
                todo.append(p)
        remaining = len(todo)
        if max_trials is not None:
            todo = todo[:max_trials]
        # one fleet program per engine primes every cold trial's envelopes
        # (hier trials walk their own segmentations — nothing to prime)
        by_engine: dict[str, list] = {}
        for p in todo:
            if p.segmentation == "hier":
                continue
            by_engine.setdefault(p.engine, []).append(
                (self._spec(p), p.lookup_bits))
        for engine, pairs in by_engine.items():
            self._explorer(engine).prime_envelopes(pairs)
        for p in todo:
            rec = self._evaluate(p)
            self.store.append(rec)
            records[p.key] = rec
            self.stats["executed"] += 1
            if not rec.ok:
                self.stats["infeasible"] += 1
        if len(todo) == remaining:  # space fully evaluated
            self.write_frontier(records)
            if compact:
                self.store.compact()
        return records

    # -- frontier ----------------------------------------------------------
    def frontier(self, records: dict[str, TrialRecord] | None = None
                 ) -> dict[str, Any]:
        return build_frontier(records if records is not None
                              else self.store.load(), self.objectives)

    def frontier_path(self) -> pathlib.Path:
        return self.root / FRONTIER_FILE

    def write_frontier(self, records: dict[str, TrialRecord] | None = None
                       ) -> pathlib.Path:
        """Emit ``frontier.json`` (deterministic bytes: no timestamp)."""
        meta = run_meta(self.seed, stamp_time=False,
                        extra={"measure": self.measure, "study": self.name,
                               "device": self.device.type})
        return save_frontier(self.frontier_path(),
                             self.frontier(records), meta)

    def summary(self) -> dict[str, Any]:
        """One flat row for reports / the bench snapshot."""
        records = self.store.load()
        front = self.frontier(records)
        done = [r for r in records.values() if r.ok]
        return {
            "study": self.name,
            "measure": self.measure,
            "trials_total": len(self.space),
            "trials_recorded": len(records),
            "trials_ok": len(done),
            "trials_infeasible": len(records) - len(done),
            "executed_this_run": self.stats["executed"],
            "replayed_this_run": self.stats["replayed"],
            "frontier_points": {t: len(pts)
                                for t, pts in front["groups"].items()},
            "probe_runs": self.probe.runs,
            "probe_cache_hits": self.probe.hits,
        }
