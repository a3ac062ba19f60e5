"""Exploration results: the full per-R frontier + Pareto extraction.

The seed returned a single best ``GenResult``; serving, benchmarks and
retargeting all want the *frontier* — every feasible LUT height with its
target-units cost — so :class:`DesignSpaceResult` keeps all of it and
derives the answers (best design, Pareto set over (area, delay), minimum
feasible region count) as views. Twin of ``repro/api/result.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.decision import DecisionReport
from repro_torch.core.pareto import pareto_indices
from repro_torch.core.table import TableDesign


@dataclasses.dataclass
class ExploreEntry:
    """One explored LUT height under one target."""

    design: TableDesign
    report: DecisionReport
    area: float  # target units (NAND2-eq / LUTs / VMEM bytes)
    delay: float  # target units (FO4-ish / LUT levels / product bits)
    runtime_s: float
    objective: Any  # the target's ranking key (lower is better)

    @property
    def lookup_bits(self) -> int:
        return self.design.lookup_bits

    @property
    def area_delay(self) -> float:
        return self.area * self.delay


@dataclasses.dataclass
class DesignSpaceResult:
    """Everything one ``Explorer.explore()`` call learned about a spec."""

    spec_name: str
    target: str
    entries: list[ExploreEntry]  # ascending R, feasible heights only
    min_regions_r: int | None  # smallest R passing Eqns 9-10 (if swept)

    def __bool__(self) -> bool:
        return bool(self.entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def best(self) -> ExploreEntry:
        """Minimal-objective entry (ties: smallest R, i.e. first in sweep)."""
        if not self.entries:
            raise ValueError(f"no feasible design for {self.spec_name} "
                             f"(target {self.target})")
        return min(self.entries, key=lambda e: e.objective)

    def pareto(self) -> list[ExploreEntry]:
        """Non-dominated entries over (area, delay), ascending area.

        Delegates to :func:`repro_torch.core.pareto.pareto_indices` — the same
        frontier logic the DSE study layer uses over its 4-objective
        vectors (DESIGN.md §13)."""
        idx = pareto_indices([(e.area, e.delay) for e in self.entries])
        return [self.entries[i] for i in idx]

    @property
    def minimal_regions(self) -> ExploreEntry | None:
        """The feasible design with the fewest regions (the abstract's
        'minimum number of regions' answer), if any height was feasible."""
        return min(self.entries, key=lambda e: e.lookup_bits) if self.entries else None
