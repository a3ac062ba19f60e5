"""Plain PyTorch versions of the §II envelope kernels (twins of
``repro/kernels/dspace/ref.py`` and of the reference's ``_dd_max_rows``).

They repeat the CUDA kernels' results on any device: the parity-split
center stencil as a loop over the offset e, vectorised over rows and
centers (not the reference's O(N^2)-memory dense oracle), and the
a-interval reduction as a loop over delta. Every divisor is a tensor, never
a Python scalar: PyTorch may turn division by a scalar into a multiply by
its reciprocal, which rounds differently. ``envelope_quotient_ref`` is the
envelope kernel's divide-free quotient, for the tests.
"""
from __future__ import annotations

import torch

BIG = 3.4e38  # sentinel where no pair exists (the reference's value)


def _divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((1, 1), value, dtype=torch.float32, device=like.device)


def envelopes_parity_ref(l_rows: torch.Tensor, u_rows: torch.Tensor
                         ) -> tuple[torch.Tensor, ...]:
    """(rows, n) float32 bounds -> (m_even, m_odd, M_even, M_odd), each
    (rows, n) float32, +/-3.4e38 where center j has no pair."""
    lf = l_rows.to(torch.float32)
    uf = u_rows.to(torch.float32)
    rows, n = lf.shape
    me = torch.full((rows, n), BIG, dtype=torch.float32, device=lf.device)
    mo, be, bo = me.clone(), -me, -me
    for e in range(n):
        # even t = 2j: pairs (j-e, j+e), e >= 1, j in [e, n-1-e]
        if e >= 1 and 2 * e <= n - 1:
            d = _divisor(2.0 * e, lf)
            lo_l, lo_u = lf[:, : n - 2 * e], uf[:, : n - 2 * e]
            up = (uf[:, 2 * e:] + 1.0 - lo_l) / d
            dn = (lf[:, 2 * e:] - lo_u - 1.0) / d
            me[:, e: n - e] = torch.minimum(me[:, e: n - e], up)
            be[:, e: n - e] = torch.maximum(be[:, e: n - e], dn)
        # odd t = 2j+1: pairs (j-e, j+1+e), e >= 0, j in [e, n-2-e]
        if 2 * e + 1 <= n - 1:
            d = _divisor(2.0 * e + 1.0, lf)
            w = n - 1 - 2 * e
            lo_l, lo_u = lf[:, :w], uf[:, :w]
            up = (uf[:, 2 * e + 1:] + 1.0 - lo_l) / d
            dn = (lf[:, 2 * e + 1:] - lo_u - 1.0) / d
            mo[:, e: e + w] = torch.minimum(mo[:, e: e + w], up)
            bo[:, e: e + w] = torch.maximum(bo[:, e: e + w], dn)
        if 2 * e + 1 > n - 1:
            break
    return me, mo, be, bo


def envelopes_parity_ref_batched(l_rows: torch.Tensor, u_rows: torch.Tensor
                                 ) -> tuple[torch.Tensor, ...]:
    """Region-batched twin of ``kernel.envelopes_parity_batched``: the
    stencil above is already vectorised over the leading (region) axis."""
    return envelopes_parity_ref(l_rows, u_rows)


def envelope_quotient_ref(num: torch.Tensor, d: torch.Tensor
                          ) -> torch.Tensor:
    """The envelope kernel's quotient of float32 ``num`` by integer-valued
    float32 ``d`` in [1, 2^22): r = RN(1/d), q0 = RN(num * r), rem =
    RN(num - d * q0), q = RN(q0 + rem * r), the last two fused multiply-adds
    taken exactly in float64 and rounded once to float32 (rem is a float32,
    so its float64 sum is exact; q's float64 sum lies off every float32
    midpoint by more than a float64 rounding, csrc/dspace.cu). Equals
    ``num / d`` bitwise in the kernel's range (the proof in csrc/dspace.cu)."""
    num = num.to(torch.float32)
    d = d.to(torch.float32)
    r = torch.ones_like(d) / d
    q0 = num * r
    rem = (num.double() - d.double() * q0.double()).float()
    return (q0.double() + rem.double() * r.double()).float()


def dd_max_rows2_ref(mt: torch.Tensor, st: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both sides of the a-interval, as the two-sided kernel computes them:
    per delta the max of the float32 numerators over x, one divide, the max
    over delta. ``a_lo = max (mt[y]-st[x])/(y-x)``, ``a_hi = -max
    (mt[x]-st[y])/(y-x)``: bitwise ``(dd_max_rows_ref(mt, st),
    -dd_max_rows_ref(-st, -mt))``, since division by delta > 0 and rounding
    are monotone and RN(-st[y] - (-mt[x])) = RN(mt[x] - st[y])."""
    mt = mt.to(torch.float32)
    st = st.to(torch.float32)
    rows, t = mt.shape
    lo = torch.full((rows,), -BIG, dtype=torch.float32, device=mt.device)
    hi = lo.clone()
    for delta in range(1, t):
        d = _divisor(float(delta), mt)[0]
        num_lo = (mt[:, delta:] - st[:, : t - delta]).amax(dim=1)
        num_hi = (mt[:, : t - delta] - st[:, delta:]).amax(dim=1)
        lo = torch.maximum(lo, num_lo / d)
        hi = torch.maximum(hi, num_hi / d)
    return lo, -hi


def dd_max_rows_ref(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-wise ``max_{x<y} (g[y]-h[x])/(y-x)`` of (rows, t) float32 rows;
    -3.4e38 where t < 2 (the reference's empty-loop value)."""
    g = g.to(torch.float32)
    h = h.to(torch.float32)
    rows, t = g.shape
    best = torch.full((rows,), -BIG, dtype=torch.float32, device=g.device)
    for delta in range(1, t):
        d = (g[:, delta:] - h[:, : t - delta]) / _divisor(float(delta), g)
        best = torch.maximum(best, d.amax(dim=1))
    return best
