"""Fleet engine: one array program for the whole library manifest.

``core.batched`` collapses the ``2^R`` regions of ONE (spec, R) probe
into a single array program; the deployable artifact (``InterpLibrary``)
is a *library* of many functions. This module closes the gap: every
(kind, spec, R) probe a manifest needs is stacked into one padded
``(P, B_max, N_max)`` program — §II envelopes, Eqn 9-10 feasibility and the
Eqn 7-8 a-interval searches for **all probes of all functions at once** —
and the §III decision procedure runs in *lockstep* over the stacked
(kind, region) rows, so ``Explorer.compile()`` over a manifest is a handful
of array dispatches instead of F × R serial probes. Twin of
``repro/core/fleet.py``: in the reference the probe/region row axis shards
across devices through ``shard_map``; the port runs the whole stack as one
CUDA program on one card (``kernels/dspace``), and splitting the probe axis
over several cards waits for the distribution slice.

Layout and masking rules (DESIGN.md §11):

* ``stack_bounds``        ragged probes -> one ``(P, B_max, N_max)`` float64
                          pair. Column pads hold ``L = -inf`` / ``U = +inf``:
                          any divided difference touching a pad lane is
                          ``±inf`` and loses every min/max reduction
                          *exactly* (IEEE), so real-lane envelope values are
                          bit-identical to an unpadded run. Pad region rows
                          are all-sentinel and sliced away on unpacking.
* ``fleet_region_spaces_stacked``  the padded program itself: envelopes for
                          every (probe, region) row in one pass; the
                          a-interval reduction slices each row group back to
                          its real ``t`` range (so the hull fallback never
                          sees a sentinel).
* ``fleet_region_spaces`` the production wrapper: groups probes by row
                          width N (identical-width probes stack directly;
                          mixed-N probes never pay quadratic column-pad
                          work) and unpacks per-probe ``RegionSpace`` lists
                          bit-identical to ``batched.region_spaces``.
* ``fleet_feasible_mask`` per-probe Eqn 9-10 verdicts without materializing
                          spaces (min-R probe traffic).
* ``fleet_alg1``          vectorized, bit-identical twin of Algorithm 1
                          (``decision.alg1_interval_precision``) — the
                          decision tail's Python hot spot.
* ``fleet_decisions``     the §III procedure for F same-shape probes in
                          lockstep: shared-k rounds of candidate
                          generation, truncation trials with per-row
                          ``(k, sq_t)`` vectors, and ``finalize_design``
                          with the vectorized Algorithm 1.

Every routine is bit-identical to its per-spec twin in ``core.batched`` /
``core.decision`` (property-tested in tests/core/test_fleet.py); the serial
path stays available as the equivalence oracle, exactly as the pooled path
does for the batched engine.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import batched
from repro_torch.core.decision import alg1_interval_precision
from repro_torch.core.designspace import RegionSpace
from repro_torch.core.table import CoeffMeta

Bounds = tuple[np.ndarray, np.ndarray]

# fleet_alg1 exactness bound: bit lengths come from an exact float64 frexp,
# valid for magnitudes below 2^53 (coefficient values are < 2^45 in any
# representable design; beyond the bound we fall back to the scalar loop).
_EXACT_MAG = 1 << 52


# --------------------------------------------------------------------------
# Padded probe stacking
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetStack:
    """P ragged probes padded into one ``(P, B_max, N_max)`` float64 pair.

    ``shapes[p]`` is probe p's real ``(B_p, N_p)``; everything outside it is
    sentinel (``L = -inf`` / ``U = +inf``) — see the module docstring for
    why sentinels are exact.
    """

    L: np.ndarray
    U: np.ndarray
    shapes: tuple[tuple[int, int], ...]

    @property
    def flat(self) -> Bounds:
        p, bm, nm = self.L.shape
        return self.L.reshape(p * bm, nm), self.U.reshape(p * bm, nm)


def stack_bounds(bounds: Sequence[Bounds]) -> FleetStack:
    """Stack ragged (L, U) region-bound pairs into one padded array pair."""
    shapes = tuple((int(L.shape[0]), int(L.shape[1])) for L, _ in bounds)
    b_max = max(b for b, _ in shapes)
    n_max = max(n for _, n in shapes)
    ls = np.full((len(bounds), b_max, n_max), -np.inf)
    us = np.full((len(bounds), b_max, n_max), np.inf)
    for i, (L, U) in enumerate(bounds):
        b, n = shapes[i]
        ls[i, :b, :n] = L
        us[i, :b, :n] = U
    return FleetStack(ls, us, shapes)


# --------------------------------------------------------------------------
# §II front half over a stack: envelopes + feasibility + a-intervals
# --------------------------------------------------------------------------

def _stacked_front_half(stack: FleetStack):
    """One batched-envelope pass over every (probe, region) row of the
    padded stack, then Eqn 9 and the fused a-interval per real-width group.

    Returns float64 ``(rows, 2*N_max - 2)`` envelopes plus per-row
    ``(a_lo, a_hi, feas9)``. Rows are ``probe-major``: probe p owns rows
    ``[p*B_max, p*B_max + B_p)``. The a-interval reduction runs on each
    row's REAL ``t`` range (grouped by width), so its values — including the
    long-row hull fallback — are bit-identical to the per-probe engine.
    """
    lf, uf = stack.flat
    big_m, small_m = batched.batched_envelopes(lf, uf)
    rows = big_m.shape[0]
    # Eqn 9 over the padded t range: pad columns hold -inf < +inf and can
    # never flip a verdict
    feas9 = np.all(big_m[:, 1:] < small_m[:, 1:], axis=1)
    a_lo = np.full(rows, np.nan)
    a_hi = np.full(rows, np.nan)
    p, b_max, _ = stack.L.shape
    by_width: dict[int, list[int]] = {}
    for i, (b, n) in enumerate(stack.shapes):
        if n > 2:
            by_width.setdefault(n, []).extend(
                range(i * b_max, i * b_max + b))
    for n, rws in by_width.items():
        idx = np.asarray(rws)[feas9[np.asarray(rws)]]
        if idx.size:
            t_real = slice(1, 2 * n - 2)
            a_lo[idx], a_hi[idx] = batched._dd_interval_rows(
                big_m[idx, t_real], small_m[idx, t_real])
    return big_m, small_m, a_lo, a_hi, feas9


def _unpack_spaces(stack: FleetStack, big_m, small_m, a_lo, a_hi, feas9
                   ) -> list[list[RegionSpace]]:
    """Slice the stacked front half back into per-probe RegionSpace lists,
    matching ``batched.region_spaces`` verdict-for-verdict (including the
    n <= 2 trivial-space semantics)."""
    out: list[list[RegionSpace]] = []
    _, b_max, _ = stack.L.shape
    for i, (b, n) in enumerate(stack.shapes):
        rows = slice(i * b_max, i * b_max + b)
        if n < 2:
            out.append([RegionSpace(np.full(1, -np.inf), np.full(1, np.inf),
                                    -np.inf, np.inf, True)
                        for _ in range(b)])
            continue
        big = big_m[rows, : 2 * n - 2]
        small = small_m[rows, : 2 * n - 2]
        f9 = feas9[rows]
        if n == 2:  # Eqn 10 is vacuous; a unconstrained
            out.append([RegionSpace(big[r], small[r], -np.inf, np.inf,
                                    bool(f9[r])) for r in range(b)])
            continue
        al, ah = a_lo[rows], a_hi[rows]
        out.append([RegionSpace(big[r], small[r], float(al[r]), float(ah[r]),
                                bool(f9[r]) and bool(al[r] < ah[r]))
                    for r in range(b)])
    return out


def fleet_region_spaces_stacked(stack: FleetStack) -> list[list[RegionSpace]]:
    """All probes' RegionSpaces from ONE padded array program — exact."""
    return _unpack_spaces(stack, *_stacked_front_half(stack))


def fleet_region_spaces_device(stack: FleetStack, shards: int | None = None,
                               device="cuda") -> list[list[RegionSpace]]:
    """The padded program on ``device``: one fleet envelope-kernel launch
    with a grid over (probe, region, center tile) per real width
    (``shards`` is capped at the visible card count; the port runs one
    program whatever its value).

    Float32 envelopes (same contract as the ``pallas`` engine): a marginal
    verdict can differ from the exact engines, which per DESIGN.md §4 can
    cost a retry, never an unsound artifact. Probes too narrow for the
    kernel (N <= 2) are answered by the exact path.
    """
    from repro_torch.kernels.dspace.ops import fleet_region_envelopes_device

    p, b_max, n_max = stack.L.shape
    if n_max <= 2:
        return fleet_region_spaces_stacked(stack)
    out: list[list[RegionSpace]] = [None] * p  # type: ignore
    # one kernel launch per real width: a narrower probe's ±inf column
    # sentinels must never enter another width's f32 a-interval reduction
    # (the t-slots are sliced to each group's real range on device)
    by_width: dict[int, list[int]] = {}
    for i, (_, n) in enumerate(stack.shapes):
        by_width.setdefault(n, []).append(i)
    for n, idxs in by_width.items():
        if n <= 2:  # exact trivial semantics, recomputed from real bounds
            for i in idxs:
                b = stack.shapes[i][0]
                sub = FleetStack(stack.L[i:i + 1, :b, :n],
                                 stack.U[i:i + 1, :b, :n], ((b, n),))
                out[i] = fleet_region_spaces_stacked(sub)[0]
            continue
        big, small, a_lo, a_hi, feas9 = fleet_region_envelopes_device(
            stack.L[idxs][:, :, :n], stack.U[idxs][:, :, :n],
            shards=shards, device=device)
        for j, i in enumerate(idxs):
            b = stack.shapes[i][0]
            spaces = []
            for r in range(b):
                row = j * b_max + r
                ok = bool(feas9[row])
                lo = float(a_lo[row]) if ok else np.nan
                hi = float(a_hi[row]) if ok else np.nan
                spaces.append(RegionSpace(big[row, : 2 * n - 2],
                                          small[row, : 2 * n - 2],
                                          lo, hi, ok and lo < hi))
            out[i] = spaces
    return out


def _width_groups(bounds: Sequence[Bounds]) -> dict[int, list[int]]:
    groups: dict[int, list[int]] = {}
    for i, (L, _) in enumerate(bounds):
        groups.setdefault(int(L.shape[1]), []).append(i)
    return groups


def fleet_region_spaces(bounds: Sequence[Bounds], shards: int | None = None,
                        device="cuda") -> list[list[RegionSpace]]:
    """Per-probe RegionSpaces for a ragged probe fleet.

    Probes are grouped by row width N before stacking: identical-width
    probes (the manifest case, and every lockstep min-R round) share one
    program with zero column padding; mixed-N probes run one program per
    width so nobody pays another probe's quadratic column-pad work. Results
    are bit-identical to ``batched.region_spaces`` per probe (``shards > 1``
    routes through the float32 device program instead — same contract as
    the ``pallas`` engine, on ``device``).
    """
    out: list[list[RegionSpace]] = [None] * len(bounds)  # type: ignore
    for _, idxs in _width_groups(bounds).items():
        stack = stack_bounds([bounds[i] for i in idxs])
        if shards is not None and shards > 1 and stack.L.shape[2] > 2:
            spaces = fleet_region_spaces_device(stack, shards=shards,
                                                device=device)
        else:
            spaces = fleet_region_spaces_stacked(stack)
        for i, sp in zip(idxs, spaces):
            out[i] = sp
    return out


def fleet_feasible_mask(bounds: Sequence[Bounds]) -> np.ndarray:
    """Per-probe Eqn 9-10 verdict (`all regions feasible`) — the fleet twin
    of ``batched.regions_feasible_mask(...).all()``, one program per width
    group and no RegionSpace materialization."""
    out = np.zeros(len(bounds), bool)
    for n, idxs in _width_groups(bounds).items():
        stack = stack_bounds([bounds[i] for i in idxs])
        _, _, a_lo, a_hi, feas9 = _stacked_front_half(stack)
        _, b_max, _ = stack.L.shape
        for j, i in enumerate(idxs):
            b, n_p = stack.shapes[j]
            rows = slice(j * b_max, j * b_max + b)
            if n_p < 2:
                out[i] = True
            elif n_p == 2:
                out[i] = bool(feas9[rows].all())
            else:
                out[i] = bool((feas9[rows]
                               & (a_lo[rows] < a_hi[rows])).all())
    return out


# --------------------------------------------------------------------------
# Vectorized Algorithm 1 (the decision tail's Python hot spot)
# --------------------------------------------------------------------------

def _bit_length(s: np.ndarray) -> np.ndarray:
    """ceil(log2(s+1)) for non-negative int64 ``s < 2^53``, exactly: frexp
    returns s = m * 2^e with m in [0.5, 1), so e IS the bit length."""
    _, e = np.frexp(s.astype(np.float64))
    return e.astype(np.int64)


def fleet_alg1(sets) -> CoeffMeta:
    """Vectorized twin of ``decision.alg1_interval_precision`` — the same
    (bits, shift, signed) for every input, chosen by the same ordering.

    The per-(sign mode, truncation t, region, interval) Python loops become
    one masked ``(T, intervals)`` grid per mode: min-bits per cell, a
    segment-min over each region's intervals, and the scalar routine's
    lexicographic pick ``(width, -shift)`` with first-mode-wins ties.
    """
    rid_l: list[int] = []
    lo_l: list[int] = []
    hi_l: list[int] = []
    for r, s in enumerate(sets):
        for l, h in s.intervals:
            rid_l.append(r)
            lo_l.append(l)
            hi_l.append(h)
    n_regions = len(sets)
    if not rid_l or max(max(map(abs, lo_l)), max(map(abs, hi_l))) >= _EXACT_MAG:
        return alg1_interval_precision(sets)
    rid = np.asarray(rid_l, np.int64)
    lo = np.asarray(lo_l, np.int64)
    hi = np.asarray(hi_l, np.int64)
    # only t up to the largest magnitude's bit length can have a multiple in
    # range (beyond it every cell is sentinel and the row is skipped anyway);
    # always include t = 0 and allow t = 62 for zero-containing intervals
    mx = max(max(map(abs, lo_l)), max(map(abs, hi_l)))
    t_hi = 62 if any(l <= 0 <= h for l, h in zip(lo_l, hi_l)) else \
        min(int(_bit_length(np.asarray([mx]))[0]), 62)
    t = np.arange(t_hi + 1, dtype=np.int64)
    step = np.int64(1) << t
    sent = np.int64(127)  # > any real bit count: marks "no multiple in range"
    best: CoeffMeta | None = None
    for mode in ("pos", "neg", "signed"):
        if mode == "pos":
            m = hi >= 0
            plo, phi, prid = np.maximum(lo[m], 0), hi[m], rid[m]
        elif mode == "neg":
            m = lo <= 0
            plo, phi, prid = np.maximum(-hi[m], 0), -lo[m], rid[m]
        else:
            mp, mn = hi >= 0, lo <= 0
            plo = np.concatenate([np.maximum(lo[mp], 0), np.maximum(-hi[mn], 0)])
            phi = np.concatenate([hi[mp], -lo[mn]])
            prid = np.concatenate([rid[mp], rid[mn]])
        if prid.size == 0 or \
                np.bincount(prid, minlength=n_regions).min() == 0:
            continue  # some region has no part under this sign mode
        order = np.argsort(prid, kind="stable")
        plo, phi, prid = plo[order], phi[order], prid[order]
        offsets = np.searchsorted(prid, np.arange(n_regions))
        # smallest multiple of 2^t at or above lo, per (t, interval) cell
        s_mult = ((plo[None, :] + step[:, None] - 1) >> t[:, None]) << t[:, None]
        in_range = s_mult <= phi[None, :]
        val = np.where(s_mult > 0,
                       np.maximum(_bit_length(s_mult) - t[:, None], 0), 0)
        val = np.where(in_range, val, sent)
        # segment min over each region's intervals (ids are region-sorted and
        # every region nonempty, so reduceat segments are well-formed)
        per_tr = np.minimum.reduceat(val, offsets, axis=1)
        t_ok = (per_tr < sent).all(axis=1)
        if not t_ok.any():
            continue
        p_t = per_tr.max(axis=1)
        signed = mode == "signed"
        width = p_t + (1 if signed else 0)
        w_min = width[t_ok].min()
        t_best = int(np.flatnonzero(t_ok & (width == w_min)).max())
        meta = CoeffMeta(bits=int(p_t[t_best]), shift=t_best, signed=signed)
        if best is None or (meta.width, -meta.shift) < (best.width, -best.shift):
            best = meta
    assert best is not None, "alg1: no sign mode feasible (impossible for nonempty sets)"
    return best


# --------------------------------------------------------------------------
# Lockstep §III decision procedure over a same-shape probe group
# --------------------------------------------------------------------------

def fleet_decisions(specs, lookup_bits: int, bounds: Sequence[Bounds],
                    spaces: Sequence[list[RegionSpace]], *,
                    degree: int | None = None, policy=None,
                    k_max: int | None = None):
    """Run the §III decision procedure for F probes of identical shape
    (same in_bits and lookup_bits) in lockstep, every per-region phase
    stacked over the (kind, region) rows of the whole group.

    Returns a list of ``(TableDesign, DecisionReport) | None`` — entry i is
    bit-identical to ``decision.run_decision(specs[i], lookup_bits,
    degree=degree, policy=policy, k_max=k_max, engine="batched")``: each
    kind walks exactly the serial k / truncation ladders, only the array
    work is shared. Step 4 runs per kind with the vectorized Algorithm 1.
    """
    from repro_torch.core.decision import DecisionPolicy, finalize_design

    policy = policy or DecisionPolicy()
    k_max = policy.k_max if k_max is None else k_max
    f = len(specs)
    assert f == len(bounds) == len(spaces) and f > 0
    b_regions, n = bounds[0][0].shape
    assert all(b[0].shape == (b_regions, n) for b in bounds), \
        "fleet_decisions needs a same-shape probe group"
    w = n.bit_length() - 1  # eval bits; n == 2^w
    feas = [all(s.feasible for s in sp) for sp in spaces]

    def cat(idxs, which):
        return np.concatenate([np.asarray(bounds[i][which]) for i in idxs])

    # the k ladders below revisit the same spaces once per k round: stack
    # the envelope rows once per kind, subset per round
    env_of = {i: batched.stack_envelopes(spaces[i]) for i in range(f)
              if feas[i]}

    def lockstep_min_k(idxs, force_linear):
        """Per-kind minimal k + candidates: the serial ``minimal_k`` ladder,
        all still-searching kinds sharing each k round's array program.

        Force-linear pre-screen: ``design_candidates`` hands every region
        with ``not linear_ok`` an empty a-set *independently of k*, so a
        kind with such a region can never climb out of the ladder — the
        serial path still probes all k_max rounds for it; here it is
        excluded up front with an identical (absent) result."""
        found: dict[int, tuple[int, list]] = {}
        active = [i for i in idxs if feas[i]]
        if force_linear and n > 2:
            active = [i for i in active
                      if all(s.linear_ok for s in spaces[i])]
        for k in range(k_max + 1):
            if not active:
                break
            # cheap existence waves decide which kinds retire at this k;
            # candidate lists are materialized once, at the found k only
            # (the serial ladder discards every earlier k's lists anyway)
            sp = [s for i in active for s in spaces[i]]
            env = (np.concatenate([env_of[i][0] for i in active]),
                   np.concatenate([env_of[i][1] for i in active]))
            okv = batched.candidates_feasible(
                sp, cat(active, 0), cat(active, 1), k, force_linear, env=env)
            newly = [i for j, i in enumerate(active)
                     if okv[j * b_regions:(j + 1) * b_regions].all()]
            if newly:
                sp2 = [s for i in newly for s in spaces[i]]
                env2 = (np.concatenate([env_of[i][0] for i in newly]),
                        np.concatenate([env_of[i][1] for i in newly]))
                cands = batched.design_candidates(
                    sp2, cat(newly, 0), cat(newly, 1), k, force_linear,
                    env=env2)
                for j, i in enumerate(newly):
                    found[i] = (k, cands[j * b_regions:(j + 1) * b_regions])
            active = [i for i in active if i not in found]
        return found

    # -- step 1: minimal k and the lin-vs-quad choice per kind -------------
    lin = lockstep_min_k(range(f), True)
    linear_possible = [i in lin for i in range(f)]
    deg = [0] * f
    state: list[tuple[int, list] | None] = [None] * f
    need_quad = []
    for i in range(f):
        if degree == 1 or (degree is None and policy.prefer_linear
                           and linear_possible[i]):
            if i in lin:
                deg[i], state[i] = 1, lin[i]
        else:
            need_quad.append(i)
    quad = lockstep_min_k(need_quad, False)
    for i in need_quad:
        if i in quad:
            deg[i], state[i] = 2, quad[i]
    live = [i for i in range(f) if state[i] is not None]
    if not live:
        return [None] * f

    k_of = {i: state[i][0] for i in live}
    a_sets = {i: [[c.a for c in row] for row in state[i][1]] for i in live}
    sq_t = {i: 0 for i in live}

    def kvec(idxs):
        return np.repeat([k_of[i] for i in idxs], b_regions)

    def sqvec(idxs):
        return np.repeat([sq_t[i] for i in idxs], b_regions)

    # -- step 2: maximize square truncation, quadratic kinds in lockstep ---
    # an accepted round's rows ARE trunc candidates at (sq_t, 0) restricted
    # to the surviving a-sets, i.e. exactly what step 3's baseline would
    # recompute — keep them and skip that kind's baseline call
    step2_rows: dict[int, list] = {}
    if policy.maximize_sq_trunc and w > 0:
        active = [i for i in live if deg[i] == 2]
        for i_step in range(1, w + 1):
            if not active:
                break
            rows = batched.trunc_candidates(
                cat(active, 0), cat(active, 1), kvec(active),
                [r for i in active for r in a_sets[i]], i_step, 0)
            still = []
            for j, i in enumerate(active):
                block = rows[j * b_regions:(j + 1) * b_regions]
                if any(not c for c in block):
                    continue  # freeze at sq_t[i]
                sq_t[i] = i_step
                a_sets[i] = [[c.a for c in row] for row in block]
                step2_rows[i] = block
                still.append(i)
            active = still

    # -- step 3: baseline at (sq_t, 0), then maximize linear truncation ----
    region_cands = dict(step2_rows)
    base = [i for i in live if i not in region_cands]
    if base:
        rows = batched.trunc_candidates(
            cat(base, 0), cat(base, 1), kvec(base),
            [r for i in base for r in a_sets[i]], sqvec(base), 0)
        for j, i in enumerate(base):
            block = rows[j * b_regions:(j + 1) * b_regions]
            if any(not c for c in block):
                state[i] = None  # serial: should not happen; drop the kind
            else:
                region_cands[i] = block
    live = [i for i in live if state[i] is not None]
    lin_t = {i: 0 for i in live}
    if policy.maximize_lin_trunc and w > 0:
        active = list(live)
        for j_step in range(1, w + 1):
            if not active:
                break
            rows = batched.trunc_candidates(
                cat(active, 0), cat(active, 1), kvec(active),
                [[c.a for c in row] for i in active for row in region_cands[i]],
                sqvec(active), j_step)
            still = []
            for j, i in enumerate(active):
                block = rows[j * b_regions:(j + 1) * b_regions]
                if any(not c for c in block):
                    continue  # freeze at lin_t[i]
                lin_t[i] = j_step
                region_cands[i] = block
                still.append(i)
            active = still

    # -- step 4: Algorithm 1 tail per kind, vectorized alg1 ----------------
    out = [None] * f
    for i in live:
        out[i] = finalize_design(
            specs[i], lookup_bits, np.asarray(bounds[i][0]),
            np.asarray(bounds[i][1]), k_of[i], deg[i], sq_t[i], lin_t[i],
            region_cands[i], linear_possible[i], alg1_fn=fleet_alg1)
    return out
