"""Multi-objective Pareto-frontier extraction (minimize every axis).

One implementation shared by :class:`repro_torch.api.result.DesignSpaceResult`
(the per-spec (area, delay) frontier) and the :mod:`repro_torch.dse` study layer
(the full-stack (area, delay, -accuracy-margin, -tokens/sec) frontier).
Both previously needed the same logic; ``DesignSpaceResult.pareto`` carried
an inline 2-D copy, and the study layer would have grown a second one.

Semantics (k objectives, all minimized):

  * a point is dropped iff some *other* point weakly dominates it — every
    coordinate <= , with duplicates resolved by keeping only the first in
    the canonical order below;
  * the kept indices come back sorted by objective vector (ties broken by
    original index), i.e. ascending along the first objective — exactly the
    ordering the old 2-D code produced.

Twin of ``repro/core/pareto.py``.
"""
from __future__ import annotations

from typing import Iterable, Sequence


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Weak domination: ``a`` no worse than ``b`` on every (minimized) axis.

    Equal vectors dominate each other; callers that need strictness check
    ``a != b`` themselves (the frontier code resolves ties positionally).
    """
    if len(a) != len(b):
        raise ValueError(f"objective arity mismatch: {len(a)} vs {len(b)}")
    return all(x <= y for x, y in zip(a, b))


def pareto_indices(points: Iterable[Sequence[float]]) -> list[int]:
    """Indices of the non-dominated points, sorted by objective vector.

    Exact duplicates keep only the earliest original index — matching the
    stable-sort-then-scan behaviour of the seed's 2-D frontier. O(n * front)
    comparisons; study and R-sweep frontiers are tens of points, not
    millions.
    """
    pts = [tuple(float(x) for x in p) for p in points]
    if pts:
        k = len(pts[0])
        for p in pts:
            if len(p) != k:
                raise ValueError("ragged objective vectors")
    order = sorted(range(len(pts)), key=lambda i: (pts[i], i))
    kept: list[int] = []
    for i in order:
        # earlier kept points are sorted <= lexicographically, so checking
        # kept alone suffices: weak domination is transitive through any
        # dropped intermediary
        if not any(dominates(pts[j], pts[i]) for j in kept):
            kept.append(i)
    return kept


def pareto_front(points: Iterable[Sequence[float]]) -> list[tuple[float, ...]]:
    """The non-dominated vectors themselves, sorted ascending."""
    pts = [tuple(float(x) for x in p) for p in points]
    return [pts[i] for i in pareto_indices(pts)]
