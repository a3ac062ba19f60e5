"""Complete design-space generation (paper §II, Eqns 1-10); twin of
``repro/core/designspace.py``.

For each region ``r`` (top ``R`` input bits) with integer bound rows ``L, U``
over ``x in [0, 2^W)``, a feasible quadratic ``(a, b, c, k)`` satisfies

    forall x:  2^k L[x] <= a x^2 + b x + c < 2^k (U[x] + 1).

The chain of interval conditions:

  c:  max_x (2^k L - a x^2 - b x)  <=  c  <  min_x (2^k (U+1) - a x^2 - b x)   (1)
  b:  max_t (2^k M(t) - a t)  <  b  <  min_t (2^k m(t) - a t)                  (3,4)
  a:  max_{t<s} (M(s)-m(t))/(s-t) < a/2^k < min_{t<s} (m(s)-M(t))/(s-t)        (7,8)

with the per-sum envelopes over divided differences d(x,y) = (U[y]+1-L[x])/(y-x):

  m(t) = min_{x<y, x+y=t} (U[y]+1-L[x])/(y-x)      ("upper" slope envelope)
  M(t) = max_{x<y, x+y=t} (L[y]-U[x]-1)/(y-x)      ("lower" slope envelope)

Region feasibility (9,10): forall t: M(t) < m(t), and a_lo < a_hi above.

c-intervals are computed in exact int64 arithmetic; M/m and the a/b bounds run
in float64 and every emitted design is exhaustively re-verified (table.py).

The engine strings are the reference's (``api.config.ENGINES``): in the port
``"pallas"`` names the float32 device program, which is a CUDA kernel here.
Only that engine reads ``device`` (a torch device name; ``"cpu"`` runs the
kernels' plain versions).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import searches
from repro_torch.core.funcspec import FunctionSpec

# Enumeration caps (the design *space* is complete; exploration caps only
# bound the heuristic decision procedure, see DESIGN.md §4).
A_ENUM_CAP = 1024
A_UNCONSTRAINED = 1 << 20


def resolve_engine(engine: str | None) -> str:
    """``engine`` or ``api.config.DEFAULT_ENGINE``, validated against
    ``api.config.ENGINES`` (deferred import — same layering rule as
    :func:`repro_torch.core.searches.resolve_impl`)."""
    from repro_torch.api.config import DEFAULT_ENGINE, ENGINES

    if engine is None:
        return DEFAULT_ENGINE
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return engine


def envelopes(L: np.ndarray, U: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-sum-t envelopes M(t), m(t) as arrays of size ``2N - 2``.

    A pair ``x < y`` exists exactly for sums ``t`` in ``[1, 2N-3]``, so the
    returned arrays are indexed ``t = 0 .. 2N-3`` with index 0 a placeholder
    (-inf / +inf) and every ``t >= 1`` finite. Pure strided-slice updates — no
    scatter — one vector op per delta (this is the §II-A hot loop; the batched
    twin is ``core.batched.batched_envelopes``, the Pallas twin lives in
    kernels/dspace).
    """
    n = len(L)
    if n < 2:
        return np.full(1, -np.inf), np.full(1, np.inf)
    t_size = 2 * n - 2
    big_m = np.full(t_size, -np.inf)
    small_m = np.full(t_size, np.inf)
    lf = L.astype(np.float64)
    uf = U.astype(np.float64)
    for delta in range(1, n):
        up = (uf[delta:] + 1.0 - lf[: n - delta]) / delta
        lo = (lf[delta:] - uf[: n - delta] - 1.0) / delta
        sl = slice(delta, 2 * n - 1 - delta, 2)
        small_m[sl] = np.minimum(small_m[sl], up)
        big_m[sl] = np.maximum(big_m[sl], lo)
    return big_m, small_m


@dataclasses.dataclass
class RegionSpace:
    """Envelopes + real a-interval for one region (Eqns 9-10)."""

    big_m: np.ndarray  # M(t)
    small_m: np.ndarray  # m(t)
    a_lo: float  # sup of Eqn 8 RHS (a/2^k strictly above)
    a_hi: float  # inf of Eqn 7 RHS (a/2^k strictly below)
    feasible: bool

    @property
    def linear_ok(self) -> bool:
        return self.feasible and self.a_lo < 0.0 < self.a_hi


def region_space(L: np.ndarray, U: np.ndarray, impl: str | None = None) -> RegionSpace:
    big_m, small_m = envelopes(L, U)
    n = len(L)
    if n <= 2:
        # 1-2 evaluation points: any slope/curvature works pointwise; Eqn 10
        # is vacuous. Treat a as unconstrained (clamped later).
        lo, hi = -np.inf, np.inf
        ok = bool(np.all(big_m[1:] < small_m[1:])) if n == 2 else True
        return RegionSpace(big_m, small_m, lo, hi, ok)
    mt, st = big_m[1:], small_m[1:]  # valid t range, all finite
    if not np.all(mt < st):  # Eqn 9
        return RegionSpace(big_m, small_m, np.nan, np.nan, False)
    a_lo, *_ = searches.max_dd(mt, st, impl)  # max (M(s)-m(t))/(s-t)
    a_hi, *_ = searches.min_dd(st, mt, impl)  # min (m(s)-M(t))/(s-t)
    return RegionSpace(big_m, small_m, a_lo, a_hi, a_lo < a_hi)  # Eqn 10


def b_interval(space: RegionSpace, a: int, k: int) -> tuple[int, int]:
    """Integer interval [b_min, b_max] (inclusive) from Eqns 3-4; empty if
    b_min > b_max."""
    t_size = len(space.big_m)
    ts = np.arange(1, t_size, dtype=np.float64)
    scale = float(1 << k)
    lo = np.max(scale * space.big_m[1:] - a * ts)
    hi = np.min(scale * space.small_m[1:] - a * ts)
    b_min = int(math.floor(lo)) + 1
    b_max = int(math.ceil(hi)) - 1
    return b_min, b_max


def c_interval(L: np.ndarray, U: np.ndarray, a: int, b: int, k: int,
               sq: np.ndarray | None = None, lin: np.ndarray | None = None
               ) -> tuple[int, int]:
    """Exact integer interval [c_min, c_max] (inclusive) from Eqn 1.

    ``sq``/``lin`` override the x^2 / x basis vectors (used by the truncation
    steps of the decision procedure: sq = trunc_i(x)^2, lin = trunc_j(x)).
    """
    n = len(L)
    x = np.arange(n, dtype=np.int64)
    sq = (x * x) if sq is None else sq.astype(np.int64)
    lin = x if lin is None else lin.astype(np.int64)
    poly = int(a) * sq + int(b) * lin
    lo = (L.astype(np.int64) << k) - poly
    hi = ((U.astype(np.int64) + 1) << k) - poly
    return int(lo.max()), int(hi.min()) - 1


def a_window(space: RegionSpace, k: int, cap: int = A_ENUM_CAP
             ) -> tuple[int, int] | None:
    """The capped contiguous window [a_min, a_max] of admissible integer a
    values strictly inside (2^k a_lo, 2^k a_hi) — the exact SET that
    :func:`a_candidates` enumerates; ``None`` when empty."""
    scale = float(1 << k)
    lo = space.a_lo * scale
    hi = space.a_hi * scale
    a_min = int(math.floor(lo)) + 1 if np.isfinite(lo) else -A_UNCONSTRAINED
    a_max = int(math.ceil(hi)) - 1 if np.isfinite(hi) else A_UNCONSTRAINED
    if a_min > a_max:
        return None
    if a_max - a_min + 1 > cap:
        # keep the magnitude-ordered prefix around 0 or the nearest end
        center = min(max(0, a_min), a_max)
        half = cap // 2
        a_min2 = max(a_min, center - half)
        a_max2 = min(a_max, a_min2 + cap - 1)
        a_min, a_max = a_min2, a_max2
    return a_min, a_max


def a_magnitude_order(a_min: int, a_max: int):
    """Yield [a_min, a_max] in the |a|-then-negative-first order of
    ``sorted(range(a_min, a_max + 1), key=abs)`` (Python's stable sort puts
    -m before +m), without materializing the window."""
    if a_min > 0:
        yield from range(a_min, a_max + 1)
    elif a_max < 0:
        yield from range(a_max, a_min - 1, -1)
    else:
        yield 0
        m = 1
        while -m >= a_min or m <= a_max:
            if -m >= a_min:
                yield -m
            if m <= a_max:
                yield m
            m += 1


def a_candidates(space: RegionSpace, k: int, cap: int = A_ENUM_CAP) -> list[int]:
    """Integer a values strictly inside (2^k a_lo, 2^k a_hi), small |a| first."""
    win = a_window(space, k, cap)
    if win is None:
        return []
    return list(a_magnitude_order(*win))


@dataclasses.dataclass
class Candidate:
    """One surviving (a, integer-b-interval) choice for a region."""

    a: int
    b_min: int
    b_max: int


@dataclasses.dataclass
class DesignSpace:
    """The complete feasible space for (spec, R) at precision slack k."""

    spec: FunctionSpec
    lookup_bits: int
    k: int
    L: np.ndarray  # (2^R, 2^W)
    U: np.ndarray
    spaces: list[RegionSpace]
    candidates: list[list[Candidate]]  # per region
    linear: bool  # True if generated with a forced to 0

    @property
    def eval_bits(self) -> int:
        return self.spec.in_bits - self.lookup_bits  # W

    @property
    def feasible(self) -> bool:
        return all(len(c) > 0 for c in self.candidates)


def _region_candidates(space: RegionSpace, L: np.ndarray, U: np.ndarray, k: int,
                       force_linear: bool) -> list[Candidate]:
    out: list[Candidate] = []
    if not space.feasible:
        return out
    avals = [0] if force_linear else a_candidates(space, k)
    if force_linear and not (space.linear_ok or len(L) <= 2):
        return out
    n = len(L)
    for a in avals:
        if n == 1:
            lo, hi = c_interval(L, U, a, 0, k)
            if lo <= hi:
                out.append(Candidate(a, 0, 0))
            continue
        b_min, b_max = b_interval(space, a, k)
        if b_min > b_max:
            continue
        # Exact confirmation at one witness b (guards float slop in M/m);
        # widen to neighbours if the float bound was off by one.
        ok = None
        for b in (b_min, b_min + 1, b_max, b_min - 1):
            if b_min - 1 <= b <= b_max + 1:
                lo, hi = c_interval(L, U, a, b, k)
                if lo <= hi:
                    ok = b
                    break
        if ok is None:
            continue
        out.append(Candidate(a, b_min, b_max))
    return out


def _space_worker(args):
    L_row, U_row, impl = args
    return region_space(L_row, U_row, impl)


def _cand_worker(args):
    space, L_row, U_row, k, force_linear = args
    return _region_candidates(space, L_row, U_row, k, force_linear)


def compute_spaces(L: np.ndarray, U: np.ndarray, impl: str | None = None,
                   engine: str | None = None, pool=None, device="cuda"
                   ) -> list[RegionSpace]:
    """All per-region RegionSpaces under the selected engine.

    ``batched``/``pallas`` run one array program over the stacked
    ``(regions, N)`` rows; ``pooled`` is the seed's per-region dispatch
    (and the equivalence oracle — all engines agree, exactly for
    ``batched``, to float32 for ``pallas``).
    """
    engine = resolve_engine(engine)
    if engine == "pooled":
        from repro_torch.core.pmap import RegionPool

        pool = pool or RegionPool(1)
        return pool.map(_space_worker,
                        [(L[r], U[r], impl) for r in range(L.shape[0])])
    from repro_torch.core import batched

    if engine == "pallas":
        return batched.region_spaces_pallas(L, U, device=device)
    return batched.region_spaces(L, U)


def build_design_space(spec: FunctionSpec, lookup_bits: int, k: int,
                       force_linear: bool = False, impl: str | None = None,
                       spaces: list[RegionSpace] | None = None,
                       pool=None, engine: str | None = None,
                       bounds: tuple[np.ndarray, np.ndarray] | None = None,
                       device="cuda") -> DesignSpace:
    engine = resolve_engine(engine)
    L, U = bounds if bounds is not None else spec.region_bounds(lookup_bits)
    if spaces is None:
        spaces = compute_spaces(L, U, impl, engine, pool, device)
    if engine == "pooled":
        from repro_torch.core.pmap import RegionPool

        pool = pool or RegionPool(1)
        cands = pool.map(_cand_worker,
                         [(spaces[r], L[r], U[r], k, force_linear)
                          for r in range(L.shape[0])])
    else:
        from repro_torch.core import batched

        cands = batched.design_candidates(spaces, L, U, k, force_linear)
    return DesignSpace(spec, lookup_bits, k, L, U, spaces, cands, force_linear)


def regions_feasible(spec: FunctionSpec, lookup_bits: int, impl: str | None = None,
                     pool=None, engine: str | None = None,
                     bounds: tuple[np.ndarray, np.ndarray] | None = None,
                     device="cuda") -> tuple[bool, list[RegionSpace]]:
    """Eqns 9-10 over every region: does ANY piecewise quadratic exist?"""
    L, U = bounds if bounds is not None else spec.region_bounds(lookup_bits)
    spaces = compute_spaces(L, U, impl, engine, pool, device)
    return all(s.feasible for s in spaces), spaces


def minimal_k(spec: FunctionSpec, lookup_bits: int, force_linear: bool = False,
              impl: str | None = None, k_max: int = 24,
              pool=None, spaces: list[RegionSpace] | None = None,
              engine: str | None = None,
              bounds: tuple[np.ndarray, np.ndarray] | None = None,
              device="cuda") -> DesignSpace | None:
    """Decision step 1: smallest k giving >=1 integer candidate per region.

    "k can be increased until the intervals contain an integer" (paper §II);
    across all regions k is constant. ``spaces`` short-circuits the envelope
    computation — RegionSpace is target-independent, so callers (the
    ``repro_torch.api.Explorer`` session) compute it once per (spec, R) and reuse
    it across k values, targets, and decision policies.
    """
    if spaces is None:
        ok, spaces = regions_feasible(spec, lookup_bits, impl, pool=pool,
                                      engine=engine, bounds=bounds,
                                      device=device)
        if not ok:
            return None
    elif not all(s.feasible for s in spaces):
        return None
    if bounds is None:
        bounds = spec.region_bounds(lookup_bits)  # invariant across the k loop
    for k in range(k_max + 1):
        ds = build_design_space(spec, lookup_bits, k, force_linear, impl, spaces,
                                pool=pool, engine=engine, bounds=bounds,
                                device=device)
        if ds.feasible:
            return ds
    return None
