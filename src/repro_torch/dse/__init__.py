"""repro_torch.dse — persistent, resumable design-space-exploration studies
(twin of ``repro.dse``).

A :class:`Study` evaluates every :class:`TrialParams` of a
:class:`SearchSpace` exactly once on its device, journals each verdict to
an append-only on-disk store (fsync'd, torn-write safe), and emits the
multi-objective Pareto frontier over (area, delay, accuracy margin, decode
tokens/sec) that ``launch/dse.py check`` regresses against. Journals,
``study.json`` and frontiers are the reference's bytes outside their
``meta`` blocks (which stamp ``"torch"`` and the device where the
reference stamps ``"jax"`` and its backend), so a study written by either
package resumes in the other.

Layout:

  trial.py     TrialParams / TrialRecord — one full-stack configuration
               and its journaled verdict (schema-versioned)
  space.py     SearchSpace grids + the smoke/default/segment presets
  store.py     StudyStore — fsync'd jsonl journal + compacted snapshot
  probe.py     ServeProbe — decode tokens/sec via ServeEngine on a device,
               and the modeled cost constants the plan assigner reads
  study.py     Study — resumable evaluation loop over Explorer sessions
  frontier.py  frontier artifact build / save / regression compare
  record.py    schema-versioned snapshot helper shared with plans and
               bench snapshots
"""
from repro_torch.dse.frontier import (build_frontier, compare_frontiers,
                                      load_frontier, save_frontier)
from repro_torch.dse.probe import ServeProbe
from repro_torch.dse.record import (RECORD_SCHEMA, read_snapshot, run_meta,
                                    update_snapshot)
from repro_torch.dse.space import SearchSpace, default_space, smoke_space
from repro_torch.dse.store import StoreCorrupt, StudyStore
from repro_torch.dse.study import Study
from repro_torch.dse.trial import TrialParams, TrialRecord

__all__ = [
    "RECORD_SCHEMA", "SearchSpace", "ServeProbe", "StoreCorrupt", "Study",
    "StudyStore", "TrialParams", "TrialRecord", "build_frontier",
    "compare_frontiers", "default_space", "load_frontier", "read_snapshot",
    "run_meta", "save_frontier", "smoke_space", "update_snapshot",
]
