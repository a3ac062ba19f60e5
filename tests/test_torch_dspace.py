"""The §II envelope front half: the port's plain ``envelopes_parity*`` and
``dd_max_rows`` and the device entry points built on them, held bitwise
against the reference's Pallas kernels run in interpret mode on the same
seeded inputs (the inputs of ``tests/kernels/test_kernels.py`` and the
steep table of ``tests/core/test_fleet.py``).

Bitwise is reachable: every operation is an IEEE float32 add, subtract or
divide of small integers in the reference's order, and min / max do not
depend on order. The reference pads rows to its 128-lane tile and 3n
layout; the port masks at the row's ends instead, so the two agree on every
center j <= n - 2, the centers the real sums t in [1, 2n - 3] read (the
reference's last center j = n - 1 reads its pad lanes and is sliced off by
both).
"""
from __future__ import annotations

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


@pytest.mark.parametrize("rows,t", [(3, 125), (2, 509), (4, 2)])
def test_dd_max_rows_bitwise(rows, t):
    rng = np.random.default_rng(t)
    g = (rng.normal(0, 1000, (rows, t))).astype(np.float32)
    h = (g - rng.uniform(0, 50, (rows, t))).astype(np.float32)
    want = np.asarray(jops._dd_max_rows(jnp.asarray(g), jnp.asarray(h)))
    got = tref.dd_max_rows_ref(torch.from_numpy(g), torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(tops.dd_max_rows(torch.from_numpy(g),
                                           torch.from_numpy(h)).numpy(), want)


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
