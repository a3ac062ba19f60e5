"""The end-to-end arithmetic over a run's records: percentiles, the
window's edges, time to first token from the due time, and the gaps
between output tokens weighted by token.

A record is one request: its ``due`` time and its ``deliveries``, the
(host time, tokens) of each ``step()`` after which its output had grown.
"""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100), linear between order statistics
    (rank q/100 x (n - 1)); NaN for no values."""
    xs = sorted(values)
    if not xs:
        return math.nan
    r = q / 100 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def inside(t: float, window: tuple[float, float]) -> bool:
    """The window is open at its start and closed at its end: a delivery
    stamped at the step that opened it belongs to the warm-up."""
    return window[0] < t <= window[1]


def output_tokens(records, window) -> int:
    return sum(n for r in records for t, n in r["deliveries"]
               if inside(t, window))


def tokens_per_s(records, window) -> float:
    return output_tokens(records, window) / (window[1] - window[0])


def ttfts(records, window) -> list[float]:
    """First token minus due time, of every request whose first token
    reached the host inside the window (seconds)."""
    return [r["deliveries"][0][0] - r["due"] for r in records
            if r["deliveries"] and inside(r["deliveries"][0][0], window)]


def itls(records, window) -> list[float]:
    """One gap per output token of every delivery after a request's first
    inside the window: (this delivery - the request's previous one) / the
    tokens it carried (seconds)."""
    out = []
    for r in records:
        d = r["deliveries"]
        for (t0, _), (t1, n) in zip(d, d[1:]):
            if inside(t1, window):
                out.extend([(t1 - t0) / n] * n)
    return out
