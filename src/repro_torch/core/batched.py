"""Batched region engine: one array program for §II generation (twin of
``repro/core/batched.py``; the port's ``pallas`` engine runs the float32
device program as the CUDA envelope kernels of ``kernels/dspace`` on an
explicit ``device``).

The seed dispatched every region of the design space as an independent
Python/numpy call fanned out through a fork pool (``core.pmap``) — for a
full min-R sweep that is ``2^R`` pickle round-trips per probed R, and the
generation hot path ran as fast as pickling allows. This module computes
the §II M/m envelopes, Eqn 9-10 feasibility, the a-interval searches and
the §III truncation re-checks for **all regions at once** over stacked
``(regions, N)`` arrays:

* ``batched_envelopes``        strided per-delta sweeps batched over the
                               leading (region) axis — same float64
                               expressions as ``designspace.envelopes``,
                               so results are bit-identical.
* ``batched_max_dd/min_dd``    divided-difference searches over stacked
                               rows; per-delta sweep for short rows, the
                               O(T log T) hull per row once the scalar
                               loop beats the O(T^2) sweep. Values are
                               bit-identical to ``core.searches`` (every
                               implementation evaluates the same float64
                               slope on the argmax pair).
* ``region_spaces``            all RegionSpaces in one shot (exact).
* ``region_spaces_pallas``     the same through one envelope-kernel launch
                               with a grid over regions plus an on-device
                               parity merge + a-interval reduction
                               (kernels/dspace; float32 envelopes).
* ``design_candidates``        batched twin of the per-region
                               (a, b-interval) candidate generation.
* ``trunc_candidates``         batched twin of the §III step-2/3
                               truncation re-checks, over (region, a)
                               pairs per truncation level.

Every batched routine has a scalar twin in ``designspace``/``decision``
(the ``pooled`` engine), which stays available as the equivalence oracle —
see tests/core/test_batched.py and DESIGN.md §9.
"""
from __future__ import annotations

import concurrent.futures
import itertools
import os
import threading

import numpy as np

from repro_torch.core.designspace import (A_ENUM_CAP, Candidate,
                                          RegionSpace, a_candidates,
                                          a_magnitude_order, a_window)

# Work-shape heuristics: above this row length the O(T log T) scalar hull
# beats the O(T^2) batched per-delta sweep per row (long rows only occur at
# small region counts, where the python loop is cheap anyway).
_HULL_T_THRESHOLD = 8192
# Element budget per temporary in the pair-chunked passes (~32 MiB int64).
_CHUNK_ELEMS = 1 << 22
# Row-axis thread fan-out for the element-bound loops (numpy releases the
# GIL inside ufuncs; rows are independent, so results are bit-identical to
# the serial pass). Default 1: the loops are memory-bandwidth-bound, so
# threads only pay off with real (non-SMT-sibling) cores — opt in via
# REPRO_BATCHED_THREADS on such machines. Engaged only above a work floor.
_MAX_THREADS = max(1, int(os.environ.get("REPRO_BATCHED_THREADS", "1")))
_THREAD_WORK_FLOOR = 1 << 22  # elements of O(B*N^2) work

_executor: concurrent.futures.ThreadPoolExecutor | None = None
_executor_lock = threading.Lock()


def _get_executor() -> concurrent.futures.ThreadPoolExecutor:
    global _executor
    if _executor is None:
        with _executor_lock:
            if _executor is None:
                _executor = concurrent.futures.ThreadPoolExecutor(
                    _MAX_THREADS, thread_name_prefix="batched-region")
    return _executor


def _run_row_blocks(b: int, work: int, fn) -> None:
    """Run ``fn(row_start, row_end)`` over the whole row axis, fanned out
    across threads when the element work justifies it."""
    if _MAX_THREADS == 1 or b < 2 or work < _THREAD_WORK_FLOOR:
        fn(0, b)
        return
    k = min(_MAX_THREADS, b)
    step = -(-b // k)
    futs = [_get_executor().submit(fn, s, min(b, s + step))
            for s in range(0, b, step)]
    for f in futs:
        f.result()  # propagate worker exceptions


def _chunks(total: int, width: int):
    step = max(1, _CHUNK_ELEMS // max(width, 1))
    for s in range(0, total, step):
        yield s, min(total, s + step)


# --------------------------------------------------------------------------
# Envelopes + divided-difference searches, batched over regions
# --------------------------------------------------------------------------

def batched_envelopes(L: np.ndarray, U: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """M(t), m(t) for every region at once: two ``(B, 2N-2)`` float64 arrays.

    Row ``r`` equals ``designspace.envelopes(L[r], U[r])`` bit-for-bit: the
    per-delta strided-slice updates are the same expressions, evaluated over
    a leading batch axis.
    """
    L = np.asarray(L)
    U = np.asarray(U)
    b, n = L.shape
    if n < 2:
        return np.full((b, 1), -np.inf), np.full((b, 1), np.inf)
    lf = L.astype(np.float64)
    # Bounds are int64, so every intermediate below is an exact float64
    # integer and hoisting the +1 preserves bit-equality with the scalar
    # expressions (U[y] + 1 - L[x]) and (L[y] - U[x] - 1).
    uf1 = U.astype(np.float64) + 1.0
    # Parity-split accumulators (the kernel's center-stencil trick, DESIGN.md
    # §4/§9): a fixed delta lands on consecutive centers j of one parity, so
    # every update is a contiguous slice instead of the scalar path's
    # stride-2 read-modify-write. slot j holds t = 2j (even) / t = 2j+1 (odd).
    half = n - 1
    s_even = np.full((b, half), np.inf)
    s_odd = np.full((b, half), np.inf)
    b_even = np.full((b, half), -np.inf)
    b_odd = np.full((b, half), -np.inf)

    def block(r0: int, r1: int) -> None:
        lfb, ufb = lf[r0:r1], uf1[r0:r1]
        for delta in range(1, n):
            up = (ufb[:, delta:] - lfb[:, : n - delta]) / delta
            lo = (lfb[:, delta:] - ufb[:, : n - delta]) / delta
            e = delta // 2  # pairs (x, x+delta): j = x + e, x in [0, n-delta)
            sl = slice(e, n - e) if delta % 2 == 0 else slice(e, e + n - delta)
            tgt_s = s_even if delta % 2 == 0 else s_odd
            tgt_b = b_even if delta % 2 == 0 else b_odd
            np.minimum(tgt_s[r0:r1, sl], up, out=tgt_s[r0:r1, sl])
            np.maximum(tgt_b[r0:r1, sl], lo, out=tgt_b[r0:r1, sl])

    _run_row_blocks(b, b * n * n, block)
    t_size = 2 * n - 2
    small_m = np.empty((b, t_size))
    big_m = np.empty((b, t_size))
    small_m[:, 0::2] = s_even
    small_m[:, 1::2] = s_odd
    big_m[:, 0::2] = b_even
    big_m[:, 1::2] = b_odd
    return big_m, small_m


def batched_max_dd(g: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Row-wise ``max_{x<y} (g[y]-h[x])/(y-x)`` — values only, ``(B,)``."""
    g = np.asarray(g, np.float64)
    h = np.asarray(h, np.float64)
    b, t = g.shape
    if t < 2:
        return np.full(b, -np.inf)
    if t >= _HULL_T_THRESHOLD:
        from repro_torch.core import searches

        return np.array([searches.max_dd(g[i], h[i], "hull")[0]
                         for i in range(b)])
    best = np.full(b, -np.inf)

    def block(r0: int, r1: int) -> None:
        gb, hb = g[r0:r1], h[r0:r1]
        bb = best[r0:r1]
        for delta in range(1, t):
            # reduce-then-divide: division by a positive constant is monotone
            # in IEEE float64, so max and /delta commute — one big op saved
            # per delta, values still bit-identical to the scalar searches
            d = (gb[:, delta:] - hb[:, : t - delta]).max(axis=1)
            np.maximum(bb, d / delta, out=bb)

    _run_row_blocks(b, b * t * t, block)
    return best


def batched_min_dd(g: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Row-wise min via negation (exactly as ``searches.min_dd``)."""
    return -batched_max_dd(-np.asarray(g, np.float64),
                           -np.asarray(h, np.float64))


def _dd_interval_rows(mt: np.ndarray, st: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Fused Eqn 7-8 pair per row: (a_lo, a_hi) in ONE per-delta pass.

    a_lo = max (M[s]-m[t])/(s-t) and a_hi = min (m[s]-M[t])/(s-t) stream the
    same ``mt``/``st`` slices each delta, so fusing them halves the memory
    traffic of two separate sweeps. IEEE negation and positive-constant
    division are exact/monotone, so both values stay bit-identical to
    ``searches.max_dd`` / ``min_dd``.
    """
    b, t = mt.shape
    if t < 2:
        return np.full(b, -np.inf), np.full(b, np.inf)
    if t >= _HULL_T_THRESHOLD:
        return batched_max_dd(mt, st), batched_min_dd(st, mt)
    a_lo = np.full(b, -np.inf)
    a_hi = np.full(b, np.inf)

    def block(r0: int, r1: int) -> None:
        mb, sb = mt[r0:r1], st[r0:r1]
        lo_b, hi_b = a_lo[r0:r1], a_hi[r0:r1]
        for delta in range(1, t):
            d_lo = (mb[:, delta:] - sb[:, : t - delta]).max(axis=1)
            d_hi = (sb[:, delta:] - mb[:, : t - delta]).min(axis=1)
            np.maximum(lo_b, d_lo / delta, out=lo_b)
            np.minimum(hi_b, d_hi / delta, out=hi_b)

    _run_row_blocks(b, 2 * b * t * t, block)
    return a_lo, a_hi


# --------------------------------------------------------------------------
# RegionSpaces and feasibility for all regions
# --------------------------------------------------------------------------

def _trivial_spaces(big_m: np.ndarray, small_m: np.ndarray, n: int
                    ) -> list[RegionSpace]:
    """n <= 2: Eqn 10 is vacuous; a unconstrained (same as region_space)."""
    out = []
    for r in range(big_m.shape[0]):
        ok = bool(np.all(big_m[r, 1:] < small_m[r, 1:])) if n == 2 else True
        out.append(RegionSpace(big_m[r], small_m[r], -np.inf, np.inf, ok))
    return out


def region_spaces(L: np.ndarray, U: np.ndarray) -> list[RegionSpace]:
    """Batched-numpy twin of ``[region_space(L[r], U[r]) for r]`` — exact."""
    L = np.asarray(L)
    U = np.asarray(U)
    b, n = L.shape
    big_m, small_m = batched_envelopes(L, U)
    if n <= 2:
        return _trivial_spaces(big_m, small_m, n)
    feas9 = np.all(big_m[:, 1:] < small_m[:, 1:], axis=1)  # Eqn 9
    a_lo = np.full(b, np.nan)
    a_hi = np.full(b, np.nan)
    idx = np.flatnonzero(feas9)
    if idx.size:
        a_lo[idx], a_hi[idx] = _dd_interval_rows(big_m[idx, 1:],
                                                 small_m[idx, 1:])
    return [RegionSpace(big_m[r], small_m[r], float(a_lo[r]), float(a_hi[r]),
                        bool(feas9[r]) and bool(a_lo[r] < a_hi[r]))  # Eqn 10
            for r in range(b)]


def regions_feasible_mask(L: np.ndarray, U: np.ndarray) -> np.ndarray:
    """Eqns 9-10 verdict per region without materializing RegionSpaces.

    The min-R search probes many (spec, R) pairs it will never explore;
    this path skips the per-region object construction entirely.
    """
    L = np.asarray(L)
    U = np.asarray(U)
    b, n = L.shape
    if n < 2:
        return np.ones(b, bool)
    big_m, small_m = batched_envelopes(L, U)
    ok9 = np.all(big_m[:, 1:] < small_m[:, 1:], axis=1)
    if n <= 2:
        return ok9
    out = np.zeros(b, bool)
    idx = np.flatnonzero(ok9)
    if idx.size:
        a_lo, a_hi = _dd_interval_rows(big_m[idx, 1:], small_m[idx, 1:])
        out[idx] = a_lo < a_hi
    return out


def region_spaces_pallas(L: np.ndarray, U: np.ndarray,
                         device="cuda") -> list[RegionSpace]:
    """All RegionSpaces from one device program on ``device`` (see
    kernels/dspace/ops; ``"cpu"`` runs its plain versions).

    Float32 envelope precision: a marginal verdict can differ from the exact
    engines, which per the DESIGN.md §4 contract can cost a retry, never an
    unsound artifact (every emitted design is exhaustively re-verified).
    """
    L = np.asarray(L)
    U = np.asarray(U)
    b, n = L.shape
    if n <= 2:  # no device win possible; use the exact path
        return _trivial_spaces(*batched_envelopes(L, U), n)
    from repro_torch.kernels.dspace.ops import region_envelopes_device

    big_m, small_m, a_lo, a_hi, feas9 = region_envelopes_device(
        L, U, device=device)
    out = []
    for r in range(b):
        ok = bool(feas9[r])
        lo = float(a_lo[r]) if ok else np.nan
        hi = float(a_hi[r]) if ok else np.nan
        out.append(RegionSpace(big_m[r], small_m[r], lo, hi, ok and lo < hi))
    return out


# --------------------------------------------------------------------------
# Batched candidate generation (decision step 1 body)
# --------------------------------------------------------------------------

def _flatten_pairs(avals: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
    rid: list[int] = []
    flat: list[int] = []
    for r, av in enumerate(avals):
        rid.extend([r] * len(av))
        flat.extend(av)
    return np.asarray(rid, np.int64), np.asarray(flat, np.int64)


def stack_envelopes(spaces: list[RegionSpace]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(M, m) rows of ``spaces`` stacked once, t >= 1 columns — the ``env``
    operand of :func:`design_candidates`. The fleet engine's k ladders call
    ``design_candidates`` many times over the same spaces; stacking here
    instead of per call removes the dominant per-round overhead."""
    return (np.stack([s.big_m for s in spaces])[:, 1:],
            np.stack([s.small_m for s in spaces])[:, 1:])


def design_candidates(spaces: list[RegionSpace], L: np.ndarray, U: np.ndarray,
                      k: int, force_linear: bool,
                      env: tuple[np.ndarray, np.ndarray] | None = None
                      ) -> list[list[Candidate]]:
    """Batched twin of ``designspace._region_candidates`` for every region.

    The admissible-a enumeration is per region (tiny, capped); the Eqn 3-4
    b-intervals and the exact c-interval witness confirmations run over all
    (region, a) pairs at once, chunked to a fixed temporary budget.
    ``env`` optionally injects :func:`stack_envelopes` output (row-aligned
    with ``spaces``) so repeated calls over one space set skip restacking.
    """
    L = np.asarray(L)
    U = np.asarray(U)
    b, n = L.shape
    avals: list[list[int]] = []
    for space in spaces:
        if not space.feasible or (
                force_linear and not (space.linear_ok or n <= 2)):
            avals.append([])
        elif force_linear:
            avals.append([0])
        else:
            avals.append(a_candidates(space, k))
    if n == 1:
        # c-interval is [L << k, ((U+1) << k) - 1]: nonempty for any a
        return [[Candidate(a, 0, 0) for a in av] for av in avals]
    out: list[list[Candidate]] = [[] for _ in range(b)]
    rid, a_arr = _flatten_pairs(avals)
    if rid.size == 0:
        return out
    check = _PairCheck(spaces, L, U, k, env)
    for s, e in _chunks(len(rid), max(check.t_size, n)):
        r_c, a_c = rid[s:e], a_arr[s:e]
        ok, b_min, b_max = check(r_c, a_c)
        for i in np.flatnonzero(ok):
            out[int(r_c[i])].append(
                Candidate(int(a_c[i]), int(b_min[i]), int(b_max[i])))
    return out


class _PairCheck:
    """Shared (region, a)-pair math of the decision-step-1 body: the Eqn 3-4
    b-interval plus the exact witness confirmation, vectorized over a flat
    pair axis. Row results depend only on the row, so any grouping of calls
    (chunks, waves) yields bit-identical values."""

    def __init__(self, spaces, L, U, k: int, env=None):
        self.t_size = len(spaces[0].big_m)
        self.ts = np.arange(1, self.t_size, dtype=np.float64)
        self.big_m, self.small_m = (env if env is not None
                                    else stack_envelopes(spaces))
        self.scale = float(1 << k)
        n = L.shape[1]
        self.x = np.arange(n, dtype=np.int64)
        self.sq = self.x * self.x
        self.lo_all = L.astype(np.int64) << k
        self.hi_all = (U.astype(np.int64) + 1) << k

    def __call__(self, r_c: np.ndarray, a_c: np.ndarray):
        """-> (survives, b_min, b_max) for each (region, a) pair row."""
        # Eqns 3-4 (same float64 expressions as b_interval)
        lin_t = a_c[:, None] * self.ts[None, :]
        lo = (self.scale * self.big_m[r_c] - lin_t).max(axis=1)
        hi = (self.scale * self.small_m[r_c] - lin_t).min(axis=1)
        b_min = np.floor(lo).astype(np.int64) + 1
        b_max = np.ceil(hi).astype(np.int64) - 1
        ok_iv = b_min <= b_max
        # exact confirmation at a witness b, widened one lattice step against
        # float slop in M/m — same candidate order as _region_candidates
        base_lo = self.lo_all[r_c] - a_c[:, None] * self.sq[None, :]
        base_hi = self.hi_all[r_c] - a_c[:, None] * self.sq[None, :]
        confirmed = np.zeros(len(r_c), bool)
        for b_opt in (b_min, b_min + 1, b_max, b_min - 1):
            need = ok_iv & ~confirmed
            if not need.any():
                break
            poly_b = b_opt[:, None] * self.x[None, :]
            c_lo = (base_lo - poly_b).max(axis=1)
            c_hi = (base_hi - poly_b).min(axis=1) - 1
            confirmed |= need & (c_lo <= c_hi)
        return ok_iv & confirmed, b_min, b_max


def candidates_feasible(spaces: list[RegionSpace], L: np.ndarray,
                        U: np.ndarray, k: int, force_linear: bool,
                        env: tuple[np.ndarray, np.ndarray] | None = None
                        ) -> np.ndarray:
    """Per-region verdict ``bool(design_candidates(...)[r])`` without
    materializing the candidate lists.

    The k ladders of the decision procedure discard every candidate list
    except the final k's; this check walks the same per-region admissible-a
    enumerations in |a|-rank *waves* — one stacked pair program per rank —
    and retires a region at its first surviving candidate (the common case:
    the smallest |a|, deep inside the a-interval, survives immediately).
    Verdicts are bit-identical to the full generation: the same pair rows
    run through the same :class:`_PairCheck` expressions, and existence is
    order-independent.
    """
    L = np.asarray(L)
    U = np.asarray(U)
    b, n = L.shape
    # lazy |a|-ordered window iterators: the common case retires a region on
    # its very first candidate, so the full (capped) enumeration that
    # design_candidates sorts per region is never materialized here
    iters: list = []
    for space in spaces:
        if not space.feasible or (
                force_linear and not (space.linear_ok or n <= 2)):
            iters.append(None)
        elif force_linear:
            iters.append(iter((0,)))
        else:
            win = a_window(space, k)
            iters.append(None if win is None else a_magnitude_order(*win))
    verdict = np.zeros(b, bool)
    if n == 1:  # any a works pointwise (see design_candidates)
        verdict[:] = [it is not None for it in iters]
        return verdict
    check = _PairCheck(spaces, L, U, k, env)
    pending = [r for r in range(b) if iters[r] is not None]
    width = 1  # ranks per wave: grows geometrically so a region with NO
    # surviving candidate exhausts its enumeration in O(log cap) waves
    while pending:
        rid_l: list[int] = []
        a_l: list[int] = []
        exhausted = set()
        for r in pending:
            take = list(itertools.islice(iters[r], width))
            if len(take) < width:
                exhausted.add(r)
            rid_l.extend([r] * len(take))
            a_l.extend(take)
        r_c = np.asarray(rid_l, np.int64)
        ok, _, _ = check(r_c, np.asarray(a_l, np.int64))
        verdict[r_c[ok]] = True
        pending = [r for r in pending
                   if not verdict[r] and r not in exhausted]
        width = min(4 * width, A_ENUM_CAP)
    return verdict


# --------------------------------------------------------------------------
# Batched truncation re-checks (decision steps 2-3)
# --------------------------------------------------------------------------

def batched_linear_fit(lo: np.ndarray, hi: np.ndarray, stride: int = 1
                       ) -> list[tuple[int, int] | None]:
    """Row-wise twin of ``decision.linear_fit_interval``.

    The dd bounds, the common case (both endpoint witnesses pass) and the
    empty-interval one-step widening (``b_min > b_max``: try ``b_min - 1``
    then ``b_max + 1`` — the dominant outcome on truncation trials that kill
    feasibility) are fully vectorized; only the rare float-slop endpoint
    adjustments fall back to the scalar routine row by row, so results match
    it exactly.
    """
    c, nb = lo.shape
    res: list[tuple[int, int] | None] = [None] * c
    valid = ~(lo > hi).any(axis=1)
    if nb < 2:
        for i in np.flatnonzero(valid):
            res[int(i)] = (0, 0)
        return res
    # fused per-delta pass (the Eqn 7-8 fusion of _dd_interval_rows applies
    # verbatim: b_lo = max (lo[y]-hi[x])/(y-x), b_hi = min (hi[y]-lo[x])/..)
    b_lo, b_hi = _dd_interval_rows(lo.astype(np.float64),
                                   hi.astype(np.float64))
    b_min = np.ceil(b_lo / stride - 1e-12).astype(np.int64)
    b_max = np.floor(b_hi / stride + 1e-12).astype(np.int64)
    idx = np.arange(nb, dtype=np.int64) * stride

    def ok_vec(bv: np.ndarray) -> np.ndarray:
        t = bv[:, None] * idx[None, :]
        return (lo - t).max(axis=1) <= (hi - t).min(axis=1)

    nonempty = b_min <= b_max
    fast = valid & nonempty
    fast &= ok_vec(b_min) & ok_vec(b_max)
    for i in np.flatnonzero(fast):
        res[int(i)] = (int(b_min[i]), int(b_max[i]))
    empty = valid & ~nonempty
    if empty.any():
        # same order as the scalar routine: b_min - 1 first, then b_max + 1
        w1 = empty & ok_vec(b_min - 1)
        w2 = empty & ~w1 & ok_vec(b_max + 1)
        for i in np.flatnonzero(w1):
            res[int(i)] = (int(b_min[i]) - 1, int(b_min[i]) - 1)
        for i in np.flatnonzero(w2):
            res[int(i)] = (int(b_max[i]) + 1, int(b_max[i]) + 1)
    slow = np.flatnonzero(valid & nonempty & ~fast)
    if slow.size:
        from repro_torch.core.decision import linear_fit_interval

        for i in slow:
            res[int(i)] = linear_fit_interval(lo[i], hi[i], stride)
    return res


def trunc_candidates(L: np.ndarray, U: np.ndarray, k,
                     a_sets: list[list[int]], sq_t, lin_t: int
                     ) -> list[list[Candidate]]:
    """Batched twin of ``decision._region_trunc_candidates`` for every region:
    surviving (a, b-interval) choices under truncations ``(sq_t, lin_t)``.

    ``k`` and ``sq_t`` accept either a scalar (one spec) or a per-region
    vector — the fleet engine stacks regions of several specs, each at its
    own precision slack / square-truncation state, into one call. Per-row
    values reproduce the scalar expressions exactly.
    """
    L = np.asarray(L)
    U = np.asarray(U)
    b, n = L.shape
    out: list[list[Candidate]] = [[] for _ in range(b)]
    rid, a_arr = _flatten_pairs(a_sets)
    if rid.size == 0:
        return out
    x = np.arange(n, dtype=np.int64)
    k_arr = np.asarray(k, np.int64)
    sq_t_arr = np.asarray(sq_t, np.int64)
    if sq_t_arr.ndim:
        sq = ((x[None, :] >> sq_t_arr[:, None]) << sq_t_arr[:, None]) ** 2
    else:
        sq = ((x >> int(sq_t_arr)) << int(sq_t_arr)) ** 2
    kb = k_arr[:, None] if k_arr.ndim else k_arr
    lo_all = L.astype(np.int64) << kb
    hi_all = ((U.astype(np.int64) + 1) << kb) - 1
    nb = n >> lin_t if lin_t else n
    for s, e in _chunks(len(rid), n):
        r_c, a_c = rid[s:e], a_arr[s:e]
        sq_rows = sq[r_c] if sq.ndim == 2 else sq[None, :]
        v_lo = lo_all[r_c] - a_c[:, None] * sq_rows
        v_hi = hi_all[r_c] - a_c[:, None] * sq_rows
        if lin_t:
            v_lo = v_lo.reshape(len(r_c), nb, -1).max(axis=2)
            v_hi = v_hi.reshape(len(r_c), nb, -1).min(axis=2)
        ivs = batched_linear_fit(v_lo, v_hi, stride=1 << lin_t)
        for i, iv in enumerate(ivs):
            if iv is not None:
                out[int(r_c[i])].append(Candidate(int(a_c[i]), iv[0], iv[1]))
    return out
