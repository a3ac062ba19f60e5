"""repro_torch.dse — the twin of ``repro.dse``, as far as it is ported.

Ported: ``record.py`` (the schema-versioned snapshot envelope that plans
and bench snapshots are written in) and, in part, ``probe.py`` (the
modeled dispatch / transfer cost constants the plan assigner's throughput
model reads). The study, store, trial, space and frontier modules and
``ServeProbe`` wait for the DSE slice.
"""
from repro_torch.dse.probe import DISPATCH_COST_S, MODES, TRANSFER_COST_S
from repro_torch.dse.record import (RECORD_SCHEMA, read_snapshot, run_meta,
                                    update_snapshot)

__all__ = [
    "DISPATCH_COST_S", "MODES", "RECORD_SCHEMA", "TRANSFER_COST_S",
    "read_snapshot", "run_meta", "update_snapshot",
]
