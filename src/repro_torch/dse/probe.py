"""Serve-probe cost model (twin of ``repro/dse/probe.py``, in part).

Ported: the deterministic cost model of the reference's *modeled* score,
which the plan assigner's throughput model (``plan/assign.py``) extends
below the tick. ``ServeProbe``, ``ProbeTimeout`` and the measured ``wall``
mode wait for the DSE slice (the study loop that drives them is not
ported yet).
"""
from __future__ import annotations

# deterministic cost model (seconds) for the modeled score: one host->device
# program dispatch vs one device<->host transfer. Absolute values only scale
# the axis; the ratios are the reference's.
DISPATCH_COST_S = 1e-4
TRANSFER_COST_S = 2e-5

MODES = ("modeled", "wall", "none")
