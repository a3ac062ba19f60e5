"""The §II envelope front half: the port's plain ``envelopes_parity*`` and
``dd_max_rows`` / ``dd_max_rows2`` and the device entry points built on
them, held bitwise against the reference's Pallas kernels run in interpret
mode on the same seeded inputs (the inputs of
``tests/kernels/test_kernels.py`` and the steep table of
``tests/core/test_fleet.py``); and the envelope kernel's divide-free
quotient (``envelope_quotient_ref``) against exact rational rounding.

Bitwise is reachable: every operation is an IEEE float32 add, subtract or
divide of small integers in the reference's order, and min / max do not
depend on order. The reference pads rows to its 128-lane tile and 3n
layout; the port masks at the row's ends instead, so the two agree on every
center j <= n - 2, the centers the real sums t in [1, 2n - 3] read (the
reference's last center j = n - 1 reads its pad lanes and is sliced off by
both).
"""
from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core.funcspec import get_spec
from repro.kernels.dspace import kernel as jk
from repro.kernels.dspace import ops as jops
from repro_torch.core import designspace as tdsp
from repro_torch.core import fleet as tfleet
from repro_torch.kernels.dspace import ops as tops
from repro_torch.kernels.dspace import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_bounds(rng, shape):
    L = np.cumsum(rng.integers(0, 3, shape), axis=-1).astype(np.int64)
    return L, L + rng.integers(0, 4, shape)


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _pad_rows(a, lane_fill):
    """The reference's TILE padding of the last axis."""
    n = a.shape[-1]
    n_pad = -(-n // jk.TILE) * jk.TILE
    out = np.full(a.shape[:-1] + (n_pad,), lane_fill, np.float64)
    out[..., :n] = a
    return out


def _assert_parity_equal(got, want, n):
    """Four parity arrays, bitwise on the centers j <= n - 2."""
    for g, w in zip(got, want):
        g = np.asarray(g)[..., : n - 1]
        w = np.asarray(w)[..., : n - 1]
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [128, 256, 384])
def test_envelopes_parity_one_row_bitwise(n):
    L, U = _rand_bounds(np.random.default_rng(n), (n,))
    want = jk.envelopes_parity(jnp.asarray(L, jnp.float32),
                               jnp.asarray(U, jnp.float32))
    got = tops.envelopes_parity(_f32(L), _f32(U))
    _assert_parity_equal(got, want, n)
    # on a tile multiple the reference has no pad lanes: every center agrees
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [128, 200, 384])
def test_envelopes_pallas_drop_in_bitwise(n):
    """The drop-in for ``core.designspace.envelopes``: n = 200 is off the
    reference's tile (its pad lanes); the port takes any n."""
    L, U = _rand_bounds(np.random.default_rng(7 + n), (n,))
    want = jops.envelopes_pallas(L, U)
    got = tops.envelopes_pallas(L, U, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2 * n - 2,)
        np.testing.assert_array_equal(g, w)
    # and the float32 contract against the exact numpy core
    big, m = tdsp.envelopes(L, U)
    np.testing.assert_allclose(got[0][1:], big[1:], rtol=1e-5)
    np.testing.assert_allclose(got[1][1:], m[1:], rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 128, 200])
def test_envelopes_ref_jnp_bitwise(n):
    """The plain baseline under the reference's name: the reference's
    ``envelopes_ref_jnp`` and the port's drop-in, bitwise, on random rows
    and on the first n codes of recip-12's first region at R = 4."""
    L, U = _rand_bounds(np.random.default_rng(11 + n), (n,))
    cases = [(L, U)]
    if n >= 128:
        lo, hi = get_spec("recip", 12).region_bounds(4)  # 256 codes each
        cases.append((lo[0][:n], hi[0][:n]))
    for L, U in cases:
        got = tops.envelopes_ref_jnp(L, U)
        for g, w, d in zip(got, jops.envelopes_ref_jnp(L, U),
                           tops.envelopes_pallas(L, U, device="cpu")):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, d)


@pytest.mark.parametrize("b,n", [(4, 128), (3, 200), (2, 64)])
def test_envelopes_parity_batched_bitwise(b, n):
    L, U = _rand_bounds(np.random.default_rng(11), (b, n))
    want = jk.envelopes_parity_batched(
        jnp.asarray(_pad_rows(L, -(2.0 ** 30)), jnp.float32),
        jnp.asarray(_pad_rows(U, 2.0 ** 30), jnp.float32))
    got = tops.envelopes_parity_batched(_f32(L), _f32(U))
    _assert_parity_equal(got, want, n)
    # the batched twin is the row stencil, vectorised over regions
    for g, w in zip(got, tref.envelopes_parity_ref_batched(_f32(L),
                                                           _f32(U))):
        assert torch.equal(g, w)


def test_envelopes_parity_fleet_bitwise():
    L, U = _rand_bounds(np.random.default_rng(5), (2, 3, 128))
    want = jk.envelopes_parity_fleet(jnp.asarray(L, jnp.float32),
                                     jnp.asarray(U, jnp.float32))
    got = tops.envelopes_parity_fleet(_f32(L), _f32(U))
    for g, w in zip(got, want):
        assert g.shape == (2, 3, 128)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rows,t", [(3, 125), (2, 509), (4, 2), (3, 3)])
def test_dd_max_rows_bitwise(rows, t):
    rng = np.random.default_rng(t)
    g = (rng.normal(0, 1000, (rows, t))).astype(np.float32)
    h = (g - rng.uniform(0, 50, (rows, t))).astype(np.float32)
    want = np.asarray(jops._dd_max_rows(jnp.asarray(g), jnp.asarray(h)))
    got = tref.dd_max_rows_ref(torch.from_numpy(g), torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(tops.dd_max_rows(torch.from_numpy(g),
                                           torch.from_numpy(h)).numpy(), want)


BIG32 = np.float32(3.4e38)


def _dd_rows(kind, rows, t, seed):
    """(mt, st) a-interval rows: random M < m rows, the steep table's, or
    random rows with +-3.4e38 sentinels (no pair: -BIG in M, +BIG in m)."""
    rng = np.random.default_rng(seed)
    if kind == "steep":
        x = np.arange(16, dtype=np.int64)
        L = np.repeat((-(1 << 24) * x)[None], rows, 0)
        U = L + rng.integers(0, 9, (rows, 16))
        parity = tops.envelopes_parity_batched(_f32(L), _f32(U))
        big, m = tops._interleave(*parity)
        return big[:, 1:].numpy().copy(), m[:, 1:].numpy().copy()
    mt = rng.normal(0, 10, (rows, t)).astype(np.float32)
    st = (mt + rng.uniform(0, 5, (rows, t))).astype(np.float32)
    if kind == "sentinel":
        mt[rng.random((rows, t)) < 0.4] = -BIG32
        st[rng.random((rows, t)) < 0.4] = BIG32
    return mt, st


def _ref_pad_max(h):
    """The reference's ``_dd_max_rows`` right-pads g with -BIG: its pairs
    past the row are RN(-BIG - h[x]) / delta for x >= t - delta. Their max
    per row (-BIG with none)."""
    rows, t = h.shape
    out = np.full(rows, -BIG32, np.float32)
    with np.errstate(over="ignore"):
        for delta in range(1, t):
            num = (np.float32(-BIG32) - h[:, t - delta:]).astype(np.float32)
            q = (num / np.float32(delta)).astype(np.float32)
            out = np.maximum(out, q.max(axis=1))
    return out


@pytest.mark.parametrize("kind,rows,t", [
    ("random", 3, 125), ("random", 2, 509), ("random", 4, 2),
    ("steep", 3, 29), ("sentinel", 64, 2), ("sentinel", 64, 3),
    ("sentinel", 16, 9)])
def test_dd_max_rows2_ref_bitwise(kind, rows, t):
    """Both a-interval sides in one pass: bitwise the two one-sided calls
    ``_merge_reduce`` made (``dd_max_rows_ref(mt, st)``,
    ``-dd_max_rows_ref(-st, -mt)``) and the reference's. The port takes the
    real pairs only; the reference's -BIG right pad adds pairs past the row
    (``_ref_pad_max``), which lose to any real pair of two finite entries
    but can win a sentinel row side whose every pair meets a sentinel, so
    the reference equals max(port, its pad pairs), bitwise, on every row."""
    mt, st = _dd_rows(kind, rows, t, seed=rows * 1000 + t)
    a_lo, a_hi = tref.dd_max_rows2_ref(torch.from_numpy(mt),
                                       torch.from_numpy(st))
    one_lo = tref.dd_max_rows_ref(torch.from_numpy(mt), torch.from_numpy(st))
    one_hi = -tref.dd_max_rows_ref(torch.from_numpy(-st),
                                   torch.from_numpy(-mt))
    assert torch.equal(a_lo, one_lo) and torch.equal(a_hi, one_hi)
    got = tops.dd_max_rows2(torch.from_numpy(mt), torch.from_numpy(st))
    assert torch.equal(got[0], a_lo) and torch.equal(got[1], a_hi)
    with np.errstate(over="ignore"):
        want_lo = np.asarray(jops._dd_max_rows(jnp.asarray(mt),
                                               jnp.asarray(st)))
        want_hi = -np.asarray(jops._dd_max_rows(jnp.asarray(-st),
                                                jnp.asarray(-mt)))
    np.testing.assert_array_equal(
        want_lo, np.maximum(a_lo.numpy(), _ref_pad_max(st)))
    np.testing.assert_array_equal(
        want_hi, -np.maximum(-a_hi.numpy(), _ref_pad_max(-mt)))
    if kind != "sentinel":  # real pairs beat the pad: equal outright
        np.testing.assert_array_equal(a_lo.numpy(), want_lo)
        np.testing.assert_array_equal(a_hi.numpy(), want_hi)


def _rn32(q: Fraction) -> np.float32:
    """The float32 nearest to the rational q, ties to even (normal range)."""
    if q == 0:
        return np.float32(0.0)
    sign, q = (-1 if q < 0 else 1), abs(q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    while Fraction(2) ** e > q:
        e -= 1
    while Fraction(2) ** (e + 1) <= q:
        e += 1
    scaled = q / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    m = scaled.numerator // scaled.denominator
    rest = scaled - m
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and m % 2):
        m += 1
    return np.float32(sign * m * 2.0 ** (e - 23))


def _quotient_cases(kind):
    """(num, d) float32 pairs: integer-valued numerators, integer d."""
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        num = rng.integers(-(1 << 24), 1 << 24, 3000).astype(np.float64)
        num *= 2.0 ** rng.integers(-20, 40, 3000)
        num = np.round(num)
        d = rng.integers(1, 1 << 16, 3000)
        d[:200] = rng.integers(1, (1 << 22) - 1, 200)
    elif kind == "steep":  # the steep table's ~2^28-scale numerators
        x = np.arange(2048, dtype=np.float32)
        L = -(2.0 ** 24) * x
        U = (L + rng.integers(0, 9, 2048)).astype(np.float32)
        j = rng.integers(1, 2047, 3000)
        e = rng.integers(1, 1024, 3000)
        e = np.minimum(e, np.minimum(j, 2047 - j))
        up = (U[j + e] + np.float32(1)) - L[j - e]
        dn = (L[j + e] - U[j - e]) - np.float32(1)
        num = np.where(rng.random(3000) < 0.5, up, dn).astype(np.float64)
        d = 2 * e
    else:  # "midpoint": N / d as close to a rounding midpoint as it gets
        # x = N / d in [1, 2) is eps / d units of 2^-24 from an odd multiple
        # of 2^-24 (a midpoint) when N * 2^24 = eps (mod d): N = d + (eps *
        # 2^-24 mod d); eps = +-1 is the closest any N / d comes (u / d)
        d = rng.integers(3, (1 << 22) - 1, 3000) | 1
        eps = rng.choice([-3, -2, -1, 1, 2, 3], 3000)
        num = np.array([int(di) + (int(ei) * pow(1 << 24, -1, int(di)))
                        % int(di) for di, ei in zip(d, eps)], np.float64)
        num *= 2.0 ** rng.integers(0, 20, 3000)
    return (torch.as_tensor(num, dtype=torch.float32),
            torch.as_tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("kind", ["random", "steep", "midpoint"])
def test_envelope_quotient_is_ieee_quotient(kind):
    """The envelope kernel's divide-free quotient (RN(1/d), a product and
    two fused multiply-adds) against the exactly rounded rational N / d
    and against the IEEE divide, bitwise."""
    num, d = _quotient_cases(kind)
    got = tref.envelope_quotient_ref(num, d)
    assert torch.equal(got, num / d)
    want = [_rn32(Fraction(float(a)) / int(b)) for a, b in zip(num, d)]
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))


@pytest.mark.parametrize("tie", ["one_ulp", "equal"])
def test_envelope_quotient_min_max_near_ties(tie):
    """min / max of the kernel's quotients equal RN of the exact min / max
    over candidates whose quotients are one float32 ulp apart, or equal
    with different divisors."""
    rng = np.random.default_rng(3 if tie == "equal" else 4)
    nums, dens = [], []
    for _ in range(400):
        d1 = int(rng.integers(1, 1 << 12))
        n1 = float(np.float32(rng.integers(-(1 << 24), 1 << 24)))
        if tie == "equal":
            k = int(rng.integers(2, 64))
            n2, d2 = float(np.float32(n1 * k)), d1 * k
        else:
            q = np.float32(n1 / d1)
            q2 = np.nextafter(q, np.float32(np.inf), dtype=np.float32)
            d2 = int(rng.integers(1, 1 << 12))
            n2 = float(np.float32(float(q2) * d2))
        nums.append((n1, n2))
        dens.append((d1, d2))
    num = torch.tensor(nums, dtype=torch.float32)
    den = torch.tensor(dens, dtype=torch.float32)
    q = tref.envelope_quotient_ref(num, den)
    for row, (nn, dd) in enumerate(zip(num.tolist(), den.tolist())):
        exact = [Fraction(a) / int(b) for a, b in zip(nn, dd)]
        assert q[row].min() == _rn32(min(exact))
        assert q[row].max() == _rn32(max(exact))


@pytest.mark.parametrize("kind,bits,r", [("recip", 8, 3), ("exp2", 8, 4),
                                         ("silu", 8, 2)])
def test_region_envelopes_device_bitwise(kind, bits, r):
    """The pallas engine's front half (M, m, a_lo, a_hi, feas9)."""
    L, U = get_spec(kind, bits).region_bounds(r)
    want = jops.region_envelopes_device(L, U, interpret=True)
    got = tops.region_envelopes_device(L, U, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    # _merge_reduce's one two-sided pass equals its former two calls
    parity = tops.envelopes_parity_batched(_f32(L), _f32(U))
    big, m = tops._interleave(*parity)
    mt, st = big[:, 1:].contiguous(), m[:, 1:].contiguous()
    np.testing.assert_array_equal(got[2], tops.dd_max_rows(mt, st).double())
    np.testing.assert_array_equal(got[3],
                                  (-tops.dd_max_rows(-st, -mt)).double())


def test_steep_table_region_and_fleet_bitwise():
    """The reference's regression table: slopes of -2^24 per code, where a
    pad lane that entered the a-interval reduction would win it."""
    x = np.arange(16, dtype=np.int64)
    L = (-(1 << 24) * x).reshape(1, 16)
    U = L + 8
    want = jops.region_envelopes_device(L, U, interpret=True)
    want_fl = jops.fleet_region_envelopes_device(L[None], U[None], shards=1,
                                                 interpret=True)
    got = tops.region_envelopes_device(L, U, device="cpu")
    got_fl = tops.fleet_region_envelopes_device(L[None], U[None], shards=1,
                                                device="cpu")
    for g, gf, w, wf in zip(got, got_fl, want, want_fl):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(gf, np.asarray(wf))


def test_fleet_region_spaces_device_bitwise_ragged():
    """A ragged stack (two widths, so two launches): every RegionSpace
    equals the reference's interpret-mode fleet path."""
    pairs = [("recip", 8, 3), ("exp2", 8, 4), ("recip", 8, 4)]
    jb = [get_spec(k, b).region_bounds(r) for k, b, r in pairs]
    want = jfleet.fleet_region_spaces_device(jfleet.stack_bounds(jb),
                                             interpret=True)
    got = tfleet.fleet_region_spaces_device(tfleet.stack_bounds(jb),
                                            device="cpu")
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert g.feasible == w.feasible
            np.testing.assert_array_equal(g.big_m, w.big_m)
            np.testing.assert_array_equal(g.small_m, w.small_m)
            np.testing.assert_array_equal([g.a_lo, g.a_hi], [w.a_lo, w.a_hi])


def test_device_entry_points_refuse_narrow_rows():
    L, U = get_spec("recip", 4).region_bounds(3)  # n = 2
    with pytest.raises(ValueError, match="trivial"):
        tops.region_envelopes_device(L, U, device="cpu")
    with pytest.raises(ValueError, match="trivial"):
        tops.fleet_region_envelopes_device(L[None], U[None], device="cpu")


def test_fleet_inf_sentinels_clamp_to_pad_values():
    """Padded region rows of a stack hold +/-inf; they reach the kernel as
    the reference's finite +/-2^30 pads, and real rows are unchanged. (The
    padded row itself is sliced away when a fleet unpacks; its values read
    the reference's pad lanes, so only real rows are compared.)"""
    L, U = get_spec("recip", 8).region_bounds(3)
    L3 = np.full((1, 9, L.shape[1]), -np.inf)
    U3 = np.full((1, 9, L.shape[1]), np.inf)
    L3[0, :8], U3[0, :8] = L, U
    got = tops.fleet_region_envelopes_device(L3, U3, device="cpu")
    want = jops.fleet_region_envelopes_device(L3, U3, shards=1,
                                              interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:8], np.asarray(w)[:8])
    exact = tops.region_envelopes_device(L, U, device="cpu")
    for g, e in zip(got, exact):
        np.testing.assert_array_equal(g[:8], e)
