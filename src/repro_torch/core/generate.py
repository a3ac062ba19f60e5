"""Legacy table-generation entry points — thin shims over
``repro_torch.api`` (twin of ``repro/core/generate.py``).

.. deprecated::
    ``generate_table`` / ``sweep_lub`` / ``generate_for_r`` /
    ``min_feasible_r`` predate the :class:`repro_torch.api.Explorer`
    session and are kept for callers of the seed API. They delegate to the
    process-wide default Explorer (so they share its envelope cache and
    worker pool) and preserve the seed's exact semantics: sweep from the minimum feasible
    R over 7 heights, rank by the ASIC area-delay product.

New code should use::

    from repro_torch.api import Explorer, ExploreConfig
    with Explorer(ExploreConfig(...)) as ex:
        best = ex.explore(spec).best
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.decision import DecisionReport
from repro_torch.core.funcspec import FunctionSpec
from repro_torch.core.table import TableDesign


@dataclasses.dataclass
class GenResult:
    design: TableDesign
    report: DecisionReport
    runtime_s: float
    area: float
    delay: float

    @property
    def area_delay(self) -> float:
        return self.area * self.delay


def _as_genresult(entry) -> GenResult:
    return GenResult(entry.design, entry.report, entry.runtime_s,
                     entry.area, entry.delay)


def generate_for_r(spec: FunctionSpec, lookup_bits: int, degree: int | None = None,
                   impl: str = "hull", processes: int | None = None
                   ) -> GenResult | None:
    """Deprecated shim: one fixed-R decision run on the default Explorer
    (``processes`` is ignored — configure ``ExploreConfig.workers`` instead)."""
    from repro_torch.api import default_explorer

    entry = default_explorer().explore_r(spec, lookup_bits, target="asic",
                                         degree=degree, impl=impl)
    return None if entry is None else _as_genresult(entry)


def min_feasible_r(spec: FunctionSpec, impl: str = "hull",
                   r_max: int | None = None) -> int | None:
    """Deprecated shim: smallest R whose every region passes Eqns 9-10
    (min #regions needed — the 'minimum number of regions' knowledge the
    abstract advertises)."""
    from repro_torch.api import default_explorer

    return default_explorer().min_regions(spec, r_max=r_max, impl=impl)


def sweep_lub(spec: FunctionSpec, r_lo: int | None = None, r_hi: int | None = None,
              degree: int | None = None, impl: str = "hull") -> list[GenResult]:
    """Deprecated shim: designs across LUT heights (Fig 3's x-axis)."""
    from repro_torch.api import default_explorer

    res = default_explorer().explore(spec, target="asic", r_lo=r_lo, r_hi=r_hi,
                                     degree=degree, impl=impl)
    return [_as_genresult(e) for e in res.entries]


def generate_table(spec: FunctionSpec, lookup_bits: int | None = None,
                   degree: int | None = None, impl: str = "hull") -> GenResult:
    """Deprecated shim: best-area-delay design; fixed R if given, else swept."""
    from repro_torch.api import default_explorer

    res = default_explorer().explore(spec, target="asic", lookup_bits=lookup_bits,
                                     degree=degree, impl=impl)
    if not res.entries:
        if lookup_bits is not None:
            raise ValueError(f"no feasible design: {spec.name} R={lookup_bits}")
        raise ValueError(f"no feasible design for {spec.name}")
    return _as_genresult(res.best)
