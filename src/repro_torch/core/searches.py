"""2-D divided-difference searches (paper §II-A).

Everything in design-space generation reduces to searches of the form

    max_{x < y} D(x, y),   D(x, y) = (g(y) - h(x)) / (y - x)

(or the min, obtained by negation). Four implementations are kept on purpose:

* ``naive``      — scalar double loop; the paper's baseline.
* ``claim21``    — scalar loop with the paper's Claim II.1 column pruning
                   (reported 5x faster @ 16-bit reciprocal; benchmarked in
                   benchmarks/claim21.py).
* ``vectorized`` — per-delta numpy sweep, O(N^2) work, data-parallel
                   (the "introduce parallelism" future-work line of §V).
* ``hull``       — beyond-paper O(N log N): incremental lower convex hull of
                   the (x, h[x]) points + binary search for the tangent from
                   each (y, g[y]). Exact (maxima of slopes from an external
                   point over a point set are attained at hull vertices).

All four are property-tested for equivalence in tests/core/test_searches.py.
Twin of ``repro/core/searches.py``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Result = tuple[float, int, int]  # (value, argmax x, argmax y)

_NEG_INF: Result = (-np.inf, -1, -1)


def max_dd_naive(g: np.ndarray, h: np.ndarray) -> Result:
    n = len(g)
    best, bx, by = _NEG_INF
    for x in range(n - 1):
        hx = h[x]
        for y in range(x + 1, n):
            d = (g[y] - hx) / (y - x)
            if d > best:
                best, bx, by = d, x, y
    return best, bx, by


def max_dd_claim21(g: np.ndarray, h: np.ndarray) -> Result:
    """Claim II.1: once (x', y') is optimal among columns <= x', a later column
    x can only win if D(x', y') > (h(x) - h(x')) / (x - x')."""
    n = len(g)
    best, bx, by = _NEG_INF
    for x in range(n - 1):
        if bx >= 0:
            gate = (h[x] - h[bx]) / (x - bx)
            if best <= gate:
                continue  # no y in this column can beat the incumbent
        hx = h[x]
        for y in range(x + 1, n):
            d = (g[y] - hx) / (y - x)
            if d > best:
                best, bx, by = d, x, y
    return best, bx, by


def max_dd_vectorized(g: np.ndarray, h: np.ndarray) -> Result:
    n = len(g)
    if n < 2:
        return _NEG_INF
    g = np.asarray(g, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    best, bx, by = _NEG_INF
    for delta in range(1, n):
        d = (g[delta:] - h[: n - delta]) / delta
        i = int(np.argmax(d))
        if d[i] > best:
            best, bx, by = float(d[i]), i, i + delta
    return best, bx, by


def _hull_tangent_max(hull_x: list[int], hull_y: list[float], gx: int, gy: float) -> tuple[float, int]:
    """Max slope from external point (gx, gy) to vertices of a lower convex
    hull (hull strictly left of gx). Slopes are unimodal over vertex index."""
    lo, hi = 0, len(hull_x) - 1

    def slope(i: int) -> float:
        return (gy - hull_y[i]) / (gx - hull_x[i])

    while hi - lo > 1:
        mid = (lo + hi) // 2
        if slope(mid) < slope(mid + 1):
            lo = mid + 1
        else:
            hi = mid
    if slope(lo) >= slope(hi):
        return slope(lo), hull_x[lo]
    return slope(hi), hull_x[hi]


def max_dd_hull(g: np.ndarray, h: np.ndarray) -> Result:
    """O(N log N): sweep y ascending; maintain lower hull of (x, h[x]), x < y."""
    n = len(g)
    if n < 2:
        return _NEG_INF
    hull_x: list[int] = []
    hull_y: list[float] = []
    best, bx, by = _NEG_INF
    for y in range(1, n):
        # push x = y - 1 onto the lower hull
        x, hx = y - 1, float(h[y - 1])
        while len(hull_x) >= 2:
            x1, y1 = hull_x[-1], hull_y[-1]
            x0, y0 = hull_x[-2], hull_y[-2]
            # pop if (x1, y1) is above or on segment (x0,y0)-(x,hx)
            if (y1 - y0) * (x - x0) >= (hx - y0) * (x1 - x0):
                hull_x.pop(), hull_y.pop()
            else:
                break
        hull_x.append(x), hull_y.append(hx)
        val, arg = _hull_tangent_max(hull_x, hull_y, y, float(g[y]))
        if val > best:
            best, bx, by = val, arg, y
    return best, bx, by


IMPLS: dict[str, Callable[[np.ndarray, np.ndarray], Result]] = {
    "naive": max_dd_naive,
    "claim21": max_dd_claim21,
    "vectorized": max_dd_vectorized,
    "hull": max_dd_hull,
}

_DEFAULT_IMPL: str | None = None  # lazy memo of api.config.DEFAULT_IMPL


def resolve_impl(impl: str | None) -> str:
    """``impl`` or the single session-wide default (``api.config.DEFAULT_IMPL``).

    The import is deferred (and memoized) so the low-level search module
    never participates in the ``repro_torch.api`` import cycle.
    """
    if impl is not None:
        return impl
    global _DEFAULT_IMPL
    if _DEFAULT_IMPL is None:
        from repro_torch.api.config import DEFAULT_IMPL

        _DEFAULT_IMPL = DEFAULT_IMPL
    return _DEFAULT_IMPL


def max_dd(g: np.ndarray, h: np.ndarray, impl: str | None = None) -> Result:
    return IMPLS[resolve_impl(impl)](np.asarray(g, np.float64),
                                     np.asarray(h, np.float64))


def min_dd(g: np.ndarray, h: np.ndarray, impl: str | None = None) -> Result:
    """min_{x<y} (g[y]-h[x])/(y-x) via negation."""
    val, x, y = max_dd(-np.asarray(g, np.float64), -np.asarray(h, np.float64), impl)
    return -val, x, y
