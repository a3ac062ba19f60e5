"""Design-space exploration: the §III decision procedure + Algorithm 1.

Order (paper §III, tuned for the square-critical-path ASIC target, kept
verbatim here because the same ordering also minimizes the Pallas kernel's
integer-multiply widths and VMEM table footprint):

  1. Minimize k                  (polynomial evaluation precision)
  2. Maximize square truncation  (bits dropped from x before squaring)
  3. Maximize linear truncation  (bits dropped from x in the b*x term)
  4. Minimize a, then b, then c storage widths (Algorithm 1), pruning the
     candidate dictionary after each step; pick the first survivor per region.

Algorithm 1 is implemented twice: literally on explicit value sets
(`alg1_set_precision`) and analytically on integer intervals
(`alg1_interval_precision`) — equivalence is property-tested. Production uses
the interval form (value sets here are intervals or small unions of them).
Twin of ``repro/core/decision.py``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import searches
from repro_torch.core.designspace import Candidate, DesignSpace, minimal_k
from repro_torch.core.fixedpoint import (bit_length_of, interval_trailing_zeros,
                                   min_bits_in_interval, trailing_zeros)
from repro_torch.core.funcspec import FunctionSpec
from repro_torch.core.table import CoeffMeta, TableDesign

B_ENUM_CAP = 64


# --------------------------------------------------------------------------
# Linear (degree-1) exact feasibility: exists (b, c) with
#   forall p: Lo[p] <= b*pos[p] + c <= Hi[p]
# --------------------------------------------------------------------------

def linear_fit_interval(lo: np.ndarray, hi: np.ndarray, stride: int = 1,
                        impl: str | None = None) -> tuple[int, int] | None:
    """Integer interval [b_min, b_max] of slopes b such that some intercept c
    satisfies Lo <= b * (stride * index) + c <= Hi pointwise; None if empty.

    Derivation: c exists iff forall x,y: Lo[x] - b*px <= Hi[y] - b*py, i.e.
    max_{x<y}(Lo[y]-Hi[x])/(py-px) <= b <= min_{x<y}(Hi[y]-Lo[x])/(py-px).
    """
    if np.any(lo > hi):
        return None
    if len(lo) < 2:
        return (0, 0)
    b_lo, *_ = searches.max_dd(lo, hi, impl)
    b_hi, *_ = searches.min_dd(hi, lo, impl)
    # positions are stride*index, so real slopes divide by stride; b integer.
    b_min = int(math.ceil(b_lo / stride - 1e-12))
    b_max = int(math.floor(b_hi / stride + 1e-12))
    # exact witness check (float-slop guard): shrink/grow by one if needed
    idx = np.arange(len(lo), dtype=np.int64) * stride

    def c_ok(b: int) -> bool:
        t = b * idx
        return int((lo - t).max()) <= int((hi - t).min())

    while b_min <= b_max and not c_ok(b_min):
        b_min += 1
    while b_min <= b_max and not c_ok(b_max):
        b_max -= 1
    if b_min > b_max:
        for b in (b_min - 1, b_max + 1):
            if c_ok(b):
                return (b, b)
        return None
    return b_min, b_max


def _trunc(x: np.ndarray, bits: int) -> np.ndarray:
    return (x >> bits) << bits


def _region_trunc_candidates(L: np.ndarray, U: np.ndarray, k: int,
                             a_values: list[int], sq_t: int, lin_t: int,
                             impl: str | None = None) -> list[Candidate]:
    """Surviving (a, b-interval) choices under truncations (i, j) — exact."""
    n = len(L)
    x = np.arange(n, dtype=np.int64)
    sq = _trunc(x, sq_t) ** 2
    out: list[Candidate] = []
    lo_base = L.astype(np.int64) << k
    hi_base = ((U.astype(np.int64) + 1) << k) - 1
    n_buckets = n >> lin_t if lin_t else n
    for a in a_values:
        v_lo = lo_base - a * sq
        v_hi = hi_base - a * sq
        if lin_t:
            v_lo = v_lo.reshape(n_buckets, -1).max(axis=1)
            v_hi = v_hi.reshape(n_buckets, -1).min(axis=1)
        iv = linear_fit_interval(v_lo, v_hi, stride=1 << lin_t, impl=impl)
        if iv is not None:
            out.append(Candidate(a, iv[0], iv[1]))
    return out


# --------------------------------------------------------------------------
# Algorithm 1 — precision minimization
# --------------------------------------------------------------------------

def alg1_set_precision(sets: list[list[int]]) -> tuple[int, int]:
    """Literal Algorithm 1 on explicit non-negative value sets.

    Returns (P, t): minimal storage bits P with t truncated trailing zeros.
    """
    if any(len(s) == 0 for s in sets):
        raise ValueError("empty region set")
    t_cap = min(max(trailing_zeros(s) for s in sr) for sr in sets)
    best_p, best_t = None, 0
    for t in range(t_cap + 1):
        p_t = 0
        for sr in sets:
            pruned = [s for s in sr if trailing_zeros(s) >= t]
            p_t = max(p_t, min(max(bit_length_of(s) - t, 0) if s else 0
                               for s in pruned))
        if best_p is None or p_t < best_p:
            best_p, best_t = p_t, t
    return best_p, best_t


@dataclasses.dataclass(frozen=True)
class IntervalSet:
    """Union of disjoint inclusive integer intervals (may span signs)."""

    intervals: tuple[tuple[int, int], ...]

    @classmethod
    def single(cls, lo: int, hi: int) -> "IntervalSet":
        return cls(((lo, hi),))

    @classmethod
    def union(cls, sets: list["IntervalSet"]) -> "IntervalSet":
        ivs = sorted(i for s in sets for i in s.intervals)
        merged: list[tuple[int, int]] = []
        for lo, hi in ivs:
            if merged and lo <= merged[-1][1] + 1:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        return cls(tuple(merged))

    def abs_part(self, sign: int) -> "IntervalSet | None":
        """Non-negative magnitudes of the sign-restricted part (0 in both)."""
        out = []
        for lo, hi in self.intervals:
            if sign > 0 and hi >= 0:
                out.append((max(lo, 0), hi))
            elif sign < 0 and lo <= 0:
                out.append((max(-hi, 0), -lo))
        return IntervalSet(tuple(sorted(out))) if out else None

    def max_trailing_zeros(self) -> int:
        return max(interval_trailing_zeros(lo, hi) for lo, hi in self.intervals)

    def min_bits(self, t: int) -> int | None:
        cands = [min_bits_in_interval(lo, hi, t) for lo, hi in self.intervals]
        cands = [c for c in cands if c is not None]
        return min(cands) if cands else None

    def restrict(self, bits: int, shift: int, signed: bool, sign: int) -> "IntervalSet":
        """Intersect with representable values: s = +-(v << shift), v < 2^bits."""
        cap = ((1 << bits) - 1) << shift
        lo_cap = -cap if (signed or sign < 0) else 0
        hi_cap = cap if (signed or sign > 0) else 0
        out = []
        for lo, hi in self.intervals:
            lo2, hi2 = max(lo, lo_cap), min(hi, hi_cap)
            step = 1 << shift
            lo3 = -((-lo2) // step) * step  # ceil to multiple
            hi3 = (hi2 // step) * step  # floor to multiple
            if lo3 <= hi3:
                out.append((lo3, hi3))
        return IntervalSet(tuple(out))

    def first_value(self) -> int | None:
        """Smallest-magnitude member (ties: positive)."""
        best = None
        for lo, hi in self.intervals:
            v = lo if lo >= 0 else (hi if hi <= 0 else 0)
            if best is None or abs(v) < abs(best) or (abs(v) == abs(best) and v > best):
                best = v
        return best

    def enumerate(self, shift: int, cap: int = B_ENUM_CAP) -> list[int]:
        vals: list[int] = []
        step = 1 << shift
        for lo, hi in self.intervals:
            lo = -((-lo) // step) * step
            v = lo
            while v <= hi and len(vals) < cap * 4:
                vals.append(v)
                v += step
        vals.sort(key=abs)
        return vals[:cap]

    @property
    def empty(self) -> bool:
        return len(self.intervals) == 0


def alg1_interval_precision(sets: list[IntervalSet]) -> CoeffMeta:
    """Algorithm 1 over interval-sets, trying sign modes {pos, neg, signed}
    and returning the narrowest storage format valid for EVERY region."""
    best: CoeffMeta | None = None
    for mode in ("pos", "neg", "signed"):
        if mode == "pos":
            parts = [s.abs_part(+1) for s in sets]
            signed = False
        elif mode == "neg":
            parts = [s.abs_part(-1) for s in sets]
            signed = False
        else:
            parts = [IntervalSet.union([p for p in (s.abs_part(+1), s.abs_part(-1)) if p])
                     for s in sets]
            signed = True
        if any(p is None or p.empty for p in parts):
            continue
        t_cap = min(p.max_trailing_zeros() for p in parts)
        for t in range(min(t_cap, 62) + 1):
            per_region = [p.min_bits(t) for p in parts]
            if any(b is None for b in per_region):
                continue
            p_t = max(per_region)  # type: ignore[type-var]
            meta = CoeffMeta(bits=p_t, shift=t, signed=signed)
            if best is None or (meta.width, -meta.shift) < (best.width, -best.shift):
                best = meta
    assert best is not None, "alg1: no sign mode feasible (impossible for nonempty sets)"
    return best


# --------------------------------------------------------------------------
# Full decision procedure
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecisionPolicy:
    """Ordering knobs of the §III procedure — the part of a hardware target
    that is a *decision procedure* rather than a cost model.

    The paper's ASIC ordering maximizes both input truncations because the
    square path dominates the critical path. Other technologies weigh the
    steps differently: an FPGA soft-multiplier target still wants truncation
    (fewer logic LUTs), while a vector-unit target (Pallas/TPU) gains nothing
    from truncating — lane width is fixed — and skips straight to Algorithm 1
    width minimization. See DESIGN.md §6.
    """

    prefer_linear: bool = True  # paper rule: linear iff feasible
    maximize_sq_trunc: bool = True  # §III step 2
    maximize_lin_trunc: bool = True  # §III step 3
    k_max: int = 24


@dataclasses.dataclass
class DecisionReport:
    lookup_bits: int
    degree: int
    k: int
    sq_trunc: int
    lin_trunc: int
    widths: tuple[int, int, int]
    linear_possible: bool


def _trunc_worker(args):
    L_row, U_row, k, a_vals, i, j, impl = args
    return _region_trunc_candidates(L_row, U_row, k, a_vals, i, j, impl)


def run_decision(spec: FunctionSpec, lookup_bits: int, degree: int | None = None,
                 impl: str | None = None, k_max: int | None = None,
                 processes: int | None = None, pool=None, spaces=None,
                 policy: DecisionPolicy | None = None, engine: str | None = None,
                 bounds=None, device="cuda"
                 ) -> tuple[TableDesign, DecisionReport] | None:
    """Run the full §III procedure; returns a verified TableDesign or None if
    no piecewise polynomial of the requested degree exists at this R.

    ``engine`` selects the region backend (api.config.ENGINES): the default
    batched engine runs every per-region phase as one array program; under
    ``"pooled"``, ``processes > 1`` parallelizes the per-region work (paper
    §V future work) and an externally-owned ``pool`` takes precedence (the
    Explorer session keeps one alive across the whole R-sweep instead of
    forking per call). ``spaces`` injects precomputed per-region envelopes;
    ``policy`` swaps the step ordering — together they are what makes
    "retargeting = a modified decision procedure" cheap. ``device`` is
    where the ``pallas`` engine computes envelopes that ``spaces`` does not
    inject.
    """
    from repro_torch.core.designspace import resolve_engine
    from repro_torch.core.pmap import RegionPool

    policy = policy or DecisionPolicy()
    engine = resolve_engine(engine)
    if k_max is None:
        k_max = policy.k_max
    if engine != "pooled" or pool is not None:
        return _run_decision_pooled(spec, lookup_bits, degree, impl, k_max, pool,
                                    spaces=spaces, policy=policy, engine=engine,
                                    bounds=bounds, device=device)
    with RegionPool(processes) as owned:
        return _run_decision_pooled(spec, lookup_bits, degree, impl, k_max, owned,
                                    spaces=spaces, policy=policy, engine=engine,
                                    bounds=bounds, device=device)


def _run_decision_pooled(spec, lookup_bits, degree, impl, k_max, pool,
                         spaces=None, policy: DecisionPolicy | None = None,
                         engine: str | None = None, bounds=None,
                         device="cuda"
                         ) -> tuple[TableDesign, DecisionReport] | None:
    from repro_torch.core.designspace import resolve_engine

    policy = policy or DecisionPolicy()
    engine = resolve_engine(engine)

    def trunc_all(ds, k, a_sets, i, j):
        """Step-2/3 truncation re-checks for every region at one (i, j)."""
        if engine == "pooled":
            return pool.map(_trunc_worker,
                            [(ds.L[r], ds.U[r], k, a_sets[r], i, j, impl)
                             for r in range(len(a_sets))])
        from repro_torch.core import batched

        return batched.trunc_candidates(ds.L, ds.U, k, a_sets, i, j)

    # -- step 1: minimal k, and lin-vs-quad choice (paper: linear iff 0 is in
    # every region's a-interval — smaller, faster hardware) ----------------
    lin_ds = minimal_k(spec, lookup_bits, force_linear=True, impl=impl, k_max=k_max,
                       pool=pool, spaces=spaces, engine=engine, bounds=bounds,
                       device=device)
    linear_possible = lin_ds is not None and lin_ds.feasible
    if degree == 1 or (degree is None and policy.prefer_linear and linear_possible):
        ds = lin_ds
        deg = 1
    else:
        ds = minimal_k(spec, lookup_bits, force_linear=False, impl=impl, k_max=k_max,
                       pool=pool, spaces=spaces, engine=engine, bounds=bounds,
                       device=device)
        deg = 2
    if ds is None or not ds.feasible:
        return None

    # region count comes from the bound rows, not 2^R: a segmented caller
    # (repro_torch.segment) passes one row per same-width leaf via ``bounds``
    n_regions = len(ds.candidates)
    w = ds.eval_bits
    k = ds.k
    a_sets: list[list[int]] = [[c.a for c in ds.candidates[r]] for r in range(n_regions)]

    # -- step 2: maximize square truncation i (quadratic only) -------------
    sq_t = 0
    if policy.maximize_sq_trunc and deg == 2 and w > 0:
        for i in range(1, w + 1):
            rows = trunc_all(ds, k, a_sets, i, 0)
            if any(not c for c in rows):
                break
            sq_t, a_sets = i, [[c.a for c in cands] for cands in rows]

    # -- step 3: maximize linear truncation j ------------------------------
    lin_t = 0
    region_cands: list[list[Candidate]] = trunc_all(ds, k, a_sets, sq_t, 0)
    if any(not c for c in region_cands):
        return None  # should not happen: step-2 kept feasibility
    for j in range(1, (w if policy.maximize_lin_trunc else 0) + 1):
        trial = trunc_all(ds, k, [[c.a for c in region_cands[r]]
                                  for r in range(n_regions)], sq_t, j)
        if any(not c for c in trial):
            break
        lin_t, region_cands = j, trial

    # -- step 4: Algorithm 1 width minimization, a -> b -> c ---------------
    verify_bounds = (ds.L, ds.U) if bounds is not None else None
    return finalize_design(spec, lookup_bits, ds.L, ds.U, k, deg, sq_t, lin_t,
                           region_cands, linear_possible,
                           verify_bounds=verify_bounds)


def finalize_design(spec, lookup_bits: int, L: np.ndarray, U: np.ndarray,
                    k: int, deg: int, sq_t: int, lin_t: int,
                    region_cands: list[list[Candidate]],
                    linear_possible: bool,
                    alg1_fn=None, verify_bounds=None
                    ) -> tuple[TableDesign, DecisionReport] | None:
    """Step 4 of the §III procedure: Algorithm-1 width minimization over the
    surviving candidates (a -> b -> c), first-survivor pick per region, and
    the final exhaustive verification.

    ``alg1_fn`` must be *value-identical* to :func:`alg1_interval_precision`
    (the default); the fleet engine injects its vectorized twin
    (``repro_torch.core.fleet.fleet_alg1``), property-tested as bit-identical.
    ``verify_bounds=(L, U)`` verifies the design directly against those bound
    rows instead of ``spec.bound_arrays()`` — required when the rows are not
    the spec's full-domain reshape (segmented depth groups, where ``spec`` is
    a width-only pseudo-spec and only the first ``n_regions * 2^w`` codes are
    meaningful).
    """
    alg1 = alg1_fn if alg1_fn is not None else alg1_interval_precision
    n_regions = len(region_cands)
    w = spec.in_bits - lookup_bits
    # The interval sets fed to Algorithm 1 skip union() normalization: the
    # width search only takes min/max over each set's intervals, which is
    # insensitive to merge order (same point set either way).
    # a widths
    a_meta = alg1([
        IntervalSet(tuple((c.a, c.a) for c in region_cands[r]))
        for r in range(n_regions)
    ])
    region_cands = [
        [c for c in cands
         if not IntervalSet.single(c.a, c.a).restrict(
             a_meta.bits, a_meta.shift, a_meta.signed, 1 if c.a >= 0 else -1).empty]
        for cands in region_cands
    ]
    if any(not c for c in region_cands):
        return None
    # b widths over the union of surviving b-intervals
    b_meta = alg1([
        IntervalSet(tuple((c.b_min, c.b_max) for c in cands))
        for cands in region_cands
    ])
    # prune b to representable values; keep (a, bs) with survivors
    pruned: list[list[tuple[int, list[int]]]] = []
    for cands in region_cands:
        row = []
        for c in cands:
            iv = IntervalSet.single(c.b_min, c.b_max).restrict(
                b_meta.bits, b_meta.shift, b_meta.signed, 1 if c.b_max >= 0 else -1)
            if not b_meta.signed:
                # unsigned mode: restrict() above guessed a sign; redo both
                iv = IntervalSet.union([
                    IntervalSet.single(c.b_min, c.b_max).restrict(
                        b_meta.bits, b_meta.shift, False, +1),
                    IntervalSet.single(c.b_min, c.b_max).restrict(
                        b_meta.bits, b_meta.shift, False, -1),
                ])
            bs = iv.enumerate(b_meta.shift)
            if bs:
                row.append((c.a, bs))
        pruned.append(row)
    if any(not row for row in pruned):
        return None

    # c width over exact c-intervals of surviving (a, b) pairs — one int64
    # sweep over every (region, a, b) triple at once (identical expressions
    # to ``c_interval``, batched over a leading pair axis)
    x = np.arange(1 << w, dtype=np.int64)
    sqv = _trunc(x, sq_t) ** 2
    linv = _trunc(x, lin_t)
    rid_l: list[int] = []
    av_l: list[int] = []
    bv_l: list[int] = []
    offsets = []
    for r in range(n_regions):
        offsets.append(len(rid_l))
        for a, bs in pruned[r]:
            for b in bs:
                rid_l.append(r)
                av_l.append(a)
                bv_l.append(b)
    rid = np.asarray(rid_l, np.int64)
    poly = (np.asarray(av_l, np.int64)[:, None] * sqv[None, :]
            + np.asarray(bv_l, np.int64)[:, None] * linv[None, :])
    c_lo = ((L.astype(np.int64) << k)[rid] - poly).max(axis=1)
    c_hi = (((U.astype(np.int64) + 1) << k)[rid] - poly).min(axis=1) - 1

    c_sets = []
    for r in range(n_regions):
        end = offsets[r + 1] if r + 1 < n_regions else len(rid_l)
        ivs = tuple((int(c_lo[j]), int(c_hi[j]))
                    for j in range(offsets[r], end) if c_lo[j] <= c_hi[j])
        if not ivs:
            return None
        c_sets.append(IntervalSet(ivs))
    c_meta = alg1(c_sets)

    # final pick: first surviving (a, b, c) per region
    av = np.zeros(n_regions, dtype=np.int64)
    bv = np.zeros(n_regions, dtype=np.int64)
    cv = np.zeros(n_regions, dtype=np.int64)
    for r in range(n_regions):
        done = False
        j = offsets[r]
        for a, bs in pruned[r]:
            for b in bs:
                lo, hi = int(c_lo[j]), int(c_hi[j])
                j += 1
                if lo > hi:
                    continue
                sign = 1 if hi >= 0 else -1
                iv = IntervalSet.single(lo, hi).restrict(
                    c_meta.bits, c_meta.shift, c_meta.signed, sign)
                if not c_meta.signed and iv.empty:
                    iv = IntervalSet.single(lo, hi).restrict(
                        c_meta.bits, c_meta.shift, False, -sign)
                val = iv.first_value()
                if val is not None:
                    av[r], bv[r], cv[r] = a, b, val
                    done = True
                    break
            if done:
                break
        if not done:
            return None

    design = TableDesign(
        name=f"{spec.name}_R{lookup_bits}", in_bits=spec.in_bits,
        out_bits=spec.out_bits, lookup_bits=lookup_bits, k=k, degree=deg,
        sq_trunc=sq_t, lin_trunc=lin_t, a=av, b=bv, c=cv,
        a_meta=a_meta, b_meta=b_meta, c_meta=c_meta,
    )
    if verify_bounds is None:
        ok, _ = design.verify(spec)
    else:
        vb_lo, vb_hi = verify_bounds
        codes = np.arange(n_regions << w, dtype=np.int64)
        y = design.eval_int(codes)
        ok = bool(np.all((y >= vb_lo.reshape(-1).astype(np.int64))
                         & (y <= vb_hi.reshape(-1).astype(np.int64))))
    assert ok, f"decision produced an invalid design for {spec.name} R={lookup_bits}"
    report = DecisionReport(lookup_bits, deg, k, sq_t, lin_t,
                            design.lut_widths, linear_possible)
    return design, report
