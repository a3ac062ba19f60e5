"""The generator's core modules of the port against the reference, on the
CPU: ``core.pareto``, ``core.searches``, ``core.designspace`` and
``core.batched`` (the twins of ``tests/core/test_{pareto,searches,
designspace,batched}.py``).

Each twin feeds the same inputs, drawn from a seeded numpy generator,
through the reference function and the port's, and asserts they are equal:
bitwise for integers, candidates, verdicts and designs, and for the float64
numpy paths, which run the same expressions. The reference's property tests
draw with hypothesis; their twins draw the same kind of inputs from a seed
and run the reference's assertion on the port as well. The ``pallas``
engine runs its kernels' plain versions (``device="cpu"``) against the
reference's interpret-mode kernels.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.api.result import DesignSpaceResult as JaxResult
from repro.api.result import ExploreEntry as JaxEntry
from repro.core import batched as jbatched
from repro.core import decision as jdecision
from repro.core import designspace as jdsp
from repro.core import pareto as jpareto
from repro.core import searches as jsearches
from repro.core.funcspec import get_spec as jget_spec
from repro_torch.api.result import DesignSpaceResult, ExploreEntry
from repro_torch.core import batched, decision, pareto, searches
from repro_torch.core import designspace as dsp
from repro_torch.core.funcspec import get_spec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_float(a, b):
    return (a == b) or (np.isnan(a) and np.isnan(b))


def _same_space(a, b):
    return (np.array_equal(a.big_m, b.big_m)
            and np.array_equal(a.small_m, b.small_m)
            and _same_float(a.a_lo, b.a_lo) and _same_float(a.a_hi, b.a_hi)
            and a.feasible == b.feasible)


def _cands(cands):
    return [(c.a, c.b_min, c.b_max) for c in cands]


# ------------------------------------------------------------------ pareto

def _oracle_2d(points):
    """The seed's DesignSpaceResult.pareto algorithm (the reference test's
    oracle)."""
    front, best_delay = [], float("inf")
    for p in sorted(points):
        if p[1] < best_delay:
            front.append(p)
            best_delay = p[1]
    return front


def _int_points(rng, n, dims, hi):
    return [tuple(map(float, p)) for p in rng.integers(0, hi, (n, dims))]


def test_pareto_empty_and_singleton():
    for pts in ([], [(3.0, 4.0)]):
        assert pareto.pareto_indices(pts) == jpareto.pareto_indices(pts)
    assert pareto.pareto_indices([]) == []
    assert pareto.pareto_indices([(3.0, 4.0)]) == [0]


def test_pareto_matches_2d_oracle_random():
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 40):
        for _ in range(20):
            pts = _int_points(rng, n, 2, 6)
            got = pareto.pareto_front(pts)
            assert got == jpareto.pareto_front(pts) == _oracle_2d(pts)


def test_pareto_duplicates_keep_first_index():
    pts = [(1.0, 1.0), (1.0, 1.0), (2.0, 0.5)]
    assert pareto.pareto_indices(pts) == jpareto.pareto_indices(pts) == [0, 2]


def _check_kd(pts, kept):
    """The reference's k-D soundness and completeness assertion."""
    kept_set = set(kept)
    for j in range(len(pts)):
        if j in kept_set:
            assert not any(pareto.dominates(pts[i], pts[j])
                           and pts[i] != pts[j]
                           for i in range(len(pts)) if i != j)
        else:
            assert any(pareto.dominates(pts[i], pts[j]) for i in kept)


def test_pareto_3d_invariants_random():
    rng = np.random.default_rng(1)
    for _ in range(30):
        pts = _int_points(rng, 25, 3, 5)
        kept = pareto.pareto_indices(pts)
        assert kept == jpareto.pareto_indices(pts)
        _check_kd(pts, kept)
        assert [pts[i] for i in kept] == sorted(pts[i] for i in kept)


def test_pareto_dominates_arity_mismatch():
    for mod in (pareto, jpareto):
        with pytest.raises(ValueError):
            mod.dominates((1.0,), (1.0, 2.0))
        with pytest.raises(ValueError):
            mod.pareto_indices([(1.0, 2.0), (1.0,)])


def test_pareto_property_matches_2d_oracle():
    """Twin of the 2-D property test: 60 seeded lists of up to 30 points."""
    rng = np.random.default_rng(2)
    for _ in range(60):
        pts = _int_points(rng, int(rng.integers(0, 31)), 2, 9)
        got = pareto.pareto_front(pts)
        assert got == jpareto.pareto_front(pts) == _oracle_2d(pts)


def test_pareto_property_kd_sound_and_complete():
    """Twin of the k-D property test: 60 seeded lists of up to 25 points."""
    rng = np.random.default_rng(3)
    for _ in range(60):
        pts = _int_points(rng, int(rng.integers(0, 26)), 3, 6)
        kept = pareto.pareto_indices(pts)
        assert kept == jpareto.pareto_indices(pts)
        _check_kd(pts, kept)


def test_design_space_result_pareto():
    pairs = [(1, 5), (2, 3), (2, 4), (3, 3), (4, 1), (4, 1)]

    def entries(cls):
        return [cls(design=None, report=None, area=a, delay=d,
                    runtime_s=0.0, objective=a * d) for a, d in pairs]

    got = DesignSpaceResult("spec", "asic", entries(ExploreEntry), None)
    want = JaxResult("spec", "asic", entries(JaxEntry), None)
    front = [(e.area, e.delay) for e in got.pareto()]
    assert front == [(e.area, e.delay) for e in want.pareto()]
    assert front == _oracle_2d(pairs) == [(1, 5), (2, 3), (4, 1)]


# ---------------------------------------------------------------- searches

def _gh(rng, n, lo=-1000, hi=1000):
    return (rng.integers(lo, hi + 1, n).astype(np.float64),
            rng.integers(lo, hi + 1, n).astype(np.float64))


def test_search_impls_match_reference():
    assert list(searches.IMPLS) == list(jsearches.IMPLS)
    for impl in (None, *searches.IMPLS):
        assert searches.resolve_impl(impl) == jsearches.resolve_impl(impl)


def test_search_all_impls_agree_on_value():
    """Twin of the 200-example property test: every implementation gives
    the reference's (value, x, y), and the naive value."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        g, h = _gh(rng, int(rng.integers(2, 41)))
        ref = searches.IMPLS["naive"](g, h)[0]
        for name, impl in searches.IMPLS.items():
            got = impl(g, h)
            assert got == jsearches.IMPLS[name](g, h), name
            assert got[0] == pytest.approx(ref, rel=1e-12, abs=1e-12), name


def test_search_min_dd_is_negated_max():
    rng = np.random.default_rng(5)
    for _ in range(100):
        g, h = _gh(rng, int(rng.integers(2, 41)))
        got = searches.min_dd(g, h, "naive")
        assert got == jsearches.min_dd(g, h, "naive")
        brute = min((g[y] - h[x]) / (y - x) for x in range(len(g))
                    for y in range(x + 1, len(g)))
        assert got[0] == pytest.approx(brute)


def test_search_claim21_prunes_but_matches_on_convex_data():
    x = np.arange(200, dtype=np.float64)
    g = 0.01 * x ** 2 - x
    h = 0.01 * x ** 2 + 1.0
    pruned = searches.max_dd_claim21(g, h)
    assert pruned == jsearches.max_dd_claim21(g, h)
    assert pruned[0] == pytest.approx(searches.max_dd_naive(g, h)[0])


def test_search_argmax_is_a_true_maximizer():
    rng = np.random.default_rng(0)
    for _ in range(20):
        g, h = _gh(rng, 30, -50, 49)
        for name, impl in searches.IMPLS.items():
            val, x, y = impl(g, h)
            assert (val, x, y) == jsearches.IMPLS[name](g, h), name
            assert x < y
            assert val == pytest.approx((g[y] - h[x]) / (y - x)), name


def test_search_degenerate_sizes():
    one = np.zeros(1)
    for name, impl in searches.IMPLS.items():
        assert impl(one, one) == jsearches.IMPLS[name](one, one)
        assert impl(one, one)[0] == -np.inf


# ------------------------------------------------------------- designspace

def _brute_force_quadratic_exists(L, U, k, a_range=12, b_range=200):
    """The reference test's tiny-problem oracle: does any integer (a, b, c)
    satisfy the sandwich?"""
    x = np.arange(len(L), dtype=np.int64)
    for a in range(-a_range, a_range + 1):
        for b in range(-b_range, b_range + 1):
            poly = a * x * x + b * x
            c_lo = ((L << k) - poly).max()
            c_hi = (((U + 1) << k) - poly).min() - 1
            if c_lo <= c_hi:
                return True
    return False


def _bound_rows(rng):
    n = int(rng.choice([4, 8]))
    L = rng.integers(0, 61, n).astype(np.int64)
    return L, L + rng.integers(0, 7, n)


def test_envelopes_match_definition():
    rng = np.random.default_rng(1)
    L = rng.integers(0, 40, 8).astype(np.int64)
    U = L + rng.integers(0, 5, 8)
    M, m = dsp.envelopes(L, U)
    jM, jm = jdsp.envelopes(L, U)
    np.testing.assert_array_equal(M, jM)
    np.testing.assert_array_equal(m, jm)
    n = len(L)
    for t in range(1, 2 * n - 2):
        pairs = [(x, t - x) for x in range(n) if x < t - x < n]
        if not pairs:
            continue
        assert m[t] == pytest.approx(
            min((U[y] + 1 - L[x]) / (y - x) for x, y in pairs)), t
        assert M[t] == pytest.approx(
            max((L[y] - U[x] - 1) / (y - x) for x, y in pairs)), t


def _witnessed(L, U, cand, bs, k):
    """Whether one of the b values gives an exact integer c (the reference
    test's soundness check)."""
    x = np.arange(len(L), dtype=np.int64)
    for b in bs:
        lo_c, hi_c = dsp.c_interval(L, U, cand.a, b, k)
        assert (lo_c, hi_c) == jdsp.c_interval(L, U, cand.a, b, k)
        if lo_c <= hi_c:
            poly = cand.a * x * x + b * x + lo_c
            assert np.all(poly >> k >= L) and np.all(poly >> k <= U)
            return True
    return False


def test_feasibility_matches_brute_force():
    """Twin of the 60-example property test (k = 4): the port's space and
    candidates equal the reference's, every claimed candidate has an
    integer witness, and brute force finds nothing the space misses."""
    rng = np.random.default_rng(6)
    for _ in range(60):
        L, U = _bound_rows(rng)
        space = dsp.region_space(L, U)
        assert _same_space(space, jdsp.region_space(L, U))
        cands = dsp._region_candidates(space, L, U, 4, force_linear=False)
        assert _cands(cands) == _cands(jdsp._region_candidates(
            jdsp.region_space(L, U), L, U, 4, force_linear=False))
        for cand in cands[:3]:
            assert _witnessed(L, U, cand, (cand.b_min, cand.b_max), 4), \
                "candidate without witness"
        if _brute_force_quadratic_exists(L, U, 4):
            assert cands, "brute force found a quadratic the space missed"


def test_candidates_are_sound():
    """Twin of the 40-example property test (k = 3)."""
    rng = np.random.default_rng(7)
    for _ in range(40):
        L, U = _bound_rows(rng)
        space = dsp.region_space(L, U)
        cands = dsp._region_candidates(space, L, U, 3, force_linear=False)
        assert _cands(cands) == _cands(jdsp._region_candidates(
            jdsp.region_space(L, U), L, U, 3, force_linear=False))
        for cand in cands[:5]:
            for b in {cand.b_min, (cand.b_min + cand.b_max) // 2,
                      cand.b_max}:
                _witnessed(L, U, cand, (b,), 3)


def _same_design_space(a, b):
    return (a.k == b.k and a.linear == b.linear
            and a.lookup_bits == b.lookup_bits
            and np.array_equal(a.L, b.L) and np.array_equal(a.U, b.U)
            and all(_same_space(x, y) for x, y in zip(a.spaces, b.spaces))
            and [_cands(c) for c in a.candidates]
            == [_cands(c) for c in b.candidates])


def test_linear_flag_matches_paper_rule():
    spec, jspec = get_spec("recip", 8), jget_spec("recip", 8)
    ok, spaces = dsp.regions_feasible(spec, 4)
    jok, jspaces = jdsp.regions_feasible(jspec, 4)
    assert ok and ok == jok
    assert all(_same_space(a, b) for a, b in zip(spaces, jspaces))
    lin = dsp.minimal_k(spec, 4, force_linear=True)
    jlin = jdsp.minimal_k(jspec, 4, force_linear=True)
    assert (lin is None) == (jlin is None)
    if lin is not None:
        assert _same_design_space(lin, jlin)
    if all(s.linear_ok for s in spaces):
        assert lin is not None and lin.feasible


def test_minimal_k_is_minimal():
    spec, jspec = get_spec("recip", 8), jget_spec("recip", 8)
    ds = dsp.minimal_k(spec, 3)
    assert ds is not None
    assert _same_design_space(ds, jdsp.minimal_k(jspec, 3))
    if ds.k > 0:
        smaller = dsp.build_design_space(spec, 3, ds.k - 1, ds.linear)
        assert not smaller.feasible
        assert _same_design_space(smaller, jdsp.build_design_space(
            jspec, 3, ds.k - 1, ds.linear))


# ----------------------------------------------------------------- batched

def _rand_bounds(rng, b, n, slack=5):
    L = rng.integers(0, 60, (b, n)).astype(np.int64)
    return L, L + rng.integers(0, slack, (b, n))


@pytest.mark.parametrize("kind,bits", [("recip", 8), ("exp2", 8),
                                       ("silu", 8)])
def test_region_spaces_bitwise_match(kind, bits):
    """The batched engine equals the per-region path and the reference's
    batched engine, bitwise, down to n == 2 and n == 1 rows."""
    spec = get_spec(kind, bits)
    for lookup_bits in (0, 1, 2, 3, bits - 2, bits - 1, bits):
        L, U = spec.region_bounds(lookup_bits)
        scalar = [dsp.region_space(L[r], U[r], "hull")
                  for r in range(L.shape[0])]
        got = batched.region_spaces(L, U)
        want = jbatched.region_spaces(L, U)
        assert len(scalar) == len(got) == len(want) == 1 << lookup_bits
        for r, (s, g, w) in enumerate(zip(scalar, got, want)):
            assert _same_space(s, g) and _same_space(g, w), (lookup_bits, r)
        mask = batched.regions_feasible_mask(L, U)
        np.testing.assert_array_equal(mask,
                                      jbatched.regions_feasible_mask(L, U))
        assert list(mask) == [s.feasible for s in scalar]


def test_region_spaces_random_rows_include_infeasible():
    rng = np.random.default_rng(0)
    for n in (4, 8, 16):
        L, U = _rand_bounds(rng, 32, n, slack=3)
        got = batched.region_spaces(L, U)
        want = jbatched.region_spaces(L, U)
        for r, (g, w) in enumerate(zip(got, want)):
            assert _same_space(g, w), (n, r)
            s = dsp.region_space(L[r], U[r], "hull")
            assert s.feasible == g.feasible
        verdicts = {s.feasible for s in got}
        assert len(verdicts) == 2 or n > 4, "want a feasible/infeasible mix"


def test_batched_dd_matches_scalar_searches():
    rng = np.random.default_rng(1)
    g = rng.integers(-1000, 1000, (16, 40)).astype(np.float64)
    h = rng.integers(-1000, 1000, (16, 40)).astype(np.float64)
    mx, mn = batched.batched_max_dd(g, h), batched.batched_min_dd(g, h)
    np.testing.assert_array_equal(mx, jbatched.batched_max_dd(g, h))
    np.testing.assert_array_equal(mn, jbatched.batched_min_dd(g, h))
    for i in range(16):
        assert mx[i] == searches.max_dd(g[i], h[i], "naive")[0]
        assert mn[i] == searches.min_dd(g[i], h[i], "naive")[0]


def test_batched_dd_hull_fallback_path():
    assert batched._HULL_T_THRESHOLD == jbatched._HULL_T_THRESHOLD
    rng = np.random.default_rng(2)
    t = batched._HULL_T_THRESHOLD
    g = rng.integers(-1000, 1000, (2, t)).astype(np.float64)
    h = rng.integers(-1000, 1000, (2, t)).astype(np.float64)
    mx = batched.batched_max_dd(g, h)
    np.testing.assert_array_equal(mx, jbatched.batched_max_dd(g, h))
    for i in range(2):
        assert mx[i] == searches.max_dd(g[i], h[i], "hull")[0]


@pytest.mark.parametrize("force_linear", [False, True])
def test_design_candidates_match_per_region(force_linear):
    spec = get_spec("recip", 8)
    for lookup_bits in (2, 3, 7, 8):
        L, U = spec.region_bounds(lookup_bits)
        spaces = batched.region_spaces(L, U)
        jspaces = jbatched.region_spaces(L, U)
        for k in (0, 3, 6):
            got = [_cands(c) for c in batched.design_candidates(
                spaces, L, U, k, force_linear)]
            want = [_cands(c) for c in jbatched.design_candidates(
                jspaces, L, U, k, force_linear)]
            assert got == want, (lookup_bits, k, force_linear)
            if lookup_bits < 7 or k == 3:  # the scalar path: ~5 s a k here
                assert got == [_cands(dsp._region_candidates(
                    spaces[r], L[r], U[r], k, force_linear))
                    for r in range(L.shape[0])], (lookup_bits, k)


def test_trunc_candidates_match_per_region():
    spec = get_spec("recip", 8)
    for lookup_bits in (2, 3):
        ds = dsp.minimal_k(spec, lookup_bits, engine="batched")
        assert ds is not None
        assert _same_design_space(ds, jdsp.minimal_k(
            jget_spec("recip", 8), lookup_bits, engine="batched"))
        n_regions = 1 << lookup_bits
        a_sets = [[c.a for c in ds.candidates[r]] for r in range(n_regions)]
        for sq_t, lin_t in ((0, 0), (1, 0), (2, 1), (3, 2)):
            if max(sq_t, lin_t) > ds.eval_bits:
                continue
            per_region = [_cands(decision._region_trunc_candidates(
                ds.L[r], ds.U[r], ds.k, a_sets[r], sq_t, lin_t, "hull"))
                for r in range(n_regions)]
            got = [_cands(c) for c in batched.trunc_candidates(
                ds.L, ds.U, ds.k, a_sets, sq_t, lin_t)]
            want = [_cands(c) for c in jbatched.trunc_candidates(
                ds.L, ds.U, ds.k, a_sets, sq_t, lin_t)]
            assert got == per_region == want, (lookup_bits, sq_t, lin_t)


def test_batched_linear_fit_matches_scalar():
    rng = np.random.default_rng(3)
    lo = rng.integers(-200, 200, (64, 8)).astype(np.int64)
    hi = lo + rng.integers(0, 60, (64, 8))
    hi[::9] -= 100  # some empty (lo > hi) rows
    for stride in (1, 2, 4):
        got = batched.batched_linear_fit(lo, hi, stride)
        assert got == jbatched.batched_linear_fit(lo, hi, stride)
        for i in range(64):
            assert got[i] == decision.linear_fit_interval(lo[i], hi[i],
                                                          stride)


@pytest.mark.parametrize("kind,bits,lookup_bits",
                         [("recip", 8, 2), ("recip", 8, 4), ("exp2", 8, 3),
                          ("log2", 8, 3)])
def test_run_decision_engines_identical(kind, bits, lookup_bits):
    """The pooled and batched engines give the reference's batched design
    and report."""
    spec = get_spec(kind, bits)
    pooled = decision.run_decision(spec, lookup_bits, engine="pooled",
                                   impl="hull", device="cpu")
    bat = decision.run_decision(spec, lookup_bits, engine="batched",
                                device="cpu")
    want = jdecision.run_decision(jget_spec(kind, bits), lookup_bits,
                                  engine="batched")
    assert (pooled is None) == (bat is None) == (want is None)
    if want is None:
        return
    assert pooled[0].to_dict() == bat[0].to_dict() == want[0].to_dict()
    assert (pooled[1].linear_possible == bat[1].linear_possible
            == want[1].linear_possible)


def test_pallas_engine_matches_reference_interpret():
    """``region_spaces_pallas`` on the CPU (the kernels' plain versions)
    against the reference's interpret-mode kernels: equal verdicts, the
    float32 envelopes and a-interval equal; both within the reference's
    tolerance of the exact engine."""
    spec = get_spec("recip", 8)
    for lookup_bits in (2, 3, 5):
        L, U = spec.region_bounds(lookup_bits)
        exact = batched.region_spaces(L, U)
        got = batched.region_spaces_pallas(L, U, device="cpu")
        want = jbatched.region_spaces_pallas(L, U, interpret=True)
        for r, (e, g, w) in enumerate(zip(exact, got, want)):
            assert _same_space(g, w), (lookup_bits, r)
            np.testing.assert_allclose(g.big_m[1:], e.big_m[1:], rtol=2e-5)
            np.testing.assert_allclose(g.small_m[1:], e.small_m[1:],
                                       rtol=2e-5)
            assert g.feasible == e.feasible, (lookup_bits, r)
            if e.feasible:
                np.testing.assert_allclose([g.a_lo, g.a_hi],
                                           [e.a_lo, e.a_hi], rtol=2e-4)


def test_pallas_engine_trivial_widths_use_numpy_path():
    spec = get_spec("recip", 8)
    for lookup_bits in (7, 8):  # n == 2 / n == 1
        L, U = spec.region_bounds(lookup_bits)
        exact = batched.region_spaces(L, U)
        got = batched.region_spaces_pallas(L, U, device="cpu")
        want = jbatched.region_spaces_pallas(L, U)
        for e, g, w in zip(exact, got, want):
            assert _same_space(g, w)
            assert g.feasible == e.feasible
            assert np.array_equal(g.big_m, e.big_m)
