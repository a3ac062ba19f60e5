"""CUDA wrappers of the §II envelope kernels (``csrc/dspace.cu``), the port
of ``repro/kernels/dspace/kernel.py``.

``envelopes_parity_cuda``, ``envelopes_parity_batched_cuda`` and
``envelopes_parity_fleet_cuda`` replace the reference's three
``pallas_call`` sites (``envelopes_parity``, ``envelopes_parity_batched``,
``envelopes_parity_fleet``); all three launch the one ``(rows, n)`` kernel
and count under the reference's names. The reference's ``TILE``, its 3n
zero padding and its pad lanes are TPU layout: the kernel masks the row's
ends instead, so it takes any n and any row count.
``dd_max_rows_cuda`` is the Eqns 7-8 a-interval reduction
(``repro/kernels/dspace/ops.py`` ``_dd_max_rows``, jnp glue in the
reference, no Pallas kernel); ``dd_max_rows2_cuda`` computes both sides of
the a-interval, the reference's two calls, in one launch of the same kernel
and counts under ``dd_max_rows``. The C entries fill the outputs with the
reference's empty-loop values and a row's blocks merge into them with
order-free float atomics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dspace.ref import BIG


def _check(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda or t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 CUDA tensor expected, got "
                        f"{t.dtype} on {t.device}")


def _envelopes(l_rows: torch.Tensor, u_rows: torch.Tensor, name: str):
    """Launch the envelope kernel on (..., n) rows; four float32 tensors of
    the same shape come back."""
    _check(l_rows, name)
    _check(u_rows, name)
    if l_rows.shape != u_rows.shape or l_rows.device != u_rows.device:
        raise ValueError(f"{name}: L {tuple(l_rows.shape)} on "
                         f"{l_rows.device}, U {tuple(u_rows.shape)} on "
                         f"{u_rows.device}")
    shape = l_rows.shape
    n = shape[-1]
    rows = l_rows.numel() // max(n, 1)
    lc, uc = l_rows.contiguous(), u_rows.contiguous()
    outs = [torch.empty(shape, dtype=torch.float32, device=lc.device)
            for _ in range(4)]
    if rows == 0 or n == 0:
        return tuple(outs)
    dev = lc.device
    rc = build.load().repro_envelopes_parity(
        lc.data_ptr(), uc.data_ptr(), rows, n,
        *(o.data_ptr() for o in outs), dev.index or 0, build.stream_of(dev))
    build.check(name, rc)
    build.LAUNCHES[name] += 1
    return tuple(outs)


def envelopes_parity_cuda(l_arr: torch.Tensor, u_arr: torch.Tensor):
    """One row: (n,) float32 bounds -> (m_even, m_odd, M_even, M_odd), each
    (n,) float32, +/-3.4e38 where no pair exists."""
    if l_arr.dim() != 1:
        raise ValueError(f"envelopes_parity takes one (n,) row, got "
                         f"{tuple(l_arr.shape)}")
    return _envelopes(l_arr, u_arr, "envelopes_parity")


def envelopes_parity_batched_cuda(l_arr: torch.Tensor, u_arr: torch.Tensor):
    """Batched regions: (B, n) rows in, four (B, n) envelopes out."""
    if l_arr.dim() != 2:
        raise ValueError(f"envelopes_parity_batched takes (B, n), got "
                         f"{tuple(l_arr.shape)}")
    return _envelopes(l_arr, u_arr, "envelopes_parity_batched")


def envelopes_parity_fleet_cuda(l_arr: torch.Tensor, u_arr: torch.Tensor):
    """Fleet stack: (P, B, n) probe rows in, four (P, B, n) envelopes out."""
    if l_arr.dim() != 3:
        raise ValueError(f"envelopes_parity_fleet takes (P, B, n), got "
                         f"{tuple(l_arr.shape)}")
    return _envelopes(l_arr, u_arr, "envelopes_parity_fleet")


def _dd_rows(g: torch.Tensor, h: torch.Tensor):
    _check(g, "dd_max_rows")
    _check(h, "dd_max_rows")
    if g.dim() != 2 or g.shape != h.shape or g.device != h.device:
        raise ValueError(f"dd_max_rows: g {tuple(g.shape)} on {g.device}, "
                         f"h {tuple(h.shape)} on {h.device}")
    return g.contiguous(), h.contiguous()


def _dd_out(sides: int, rows: int, t: int, dev: torch.device):
    """(sides, rows) outputs: the C entry fills them before its launch;
    with no pair the reference's empty-loop values (-3.4e38, 3.4e38)."""
    if rows == 0 or t < 2:
        out = torch.full((sides, rows), -BIG, dtype=torch.float32,
                         device=dev)
        out[1:] = BIG
        return out
    return torch.empty((sides, rows), dtype=torch.float32, device=dev)


def dd_max_rows_cuda(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-wise ``max_{x<y} (g[y]-h[x])/(y-x)`` of (rows, t) float32 rows;
    -3.4e38 where t < 2."""
    gc, hc = _dd_rows(g, h)
    (rows, t), dev = gc.shape, gc.device
    out = _dd_out(1, rows, t, dev)[0]
    if rows == 0 or t < 2:
        return out
    rc = build.load().repro_dd_max_rows(
        gc.data_ptr(), hc.data_ptr(), rows, t, out.data_ptr(),
        dev.index or 0, build.stream_of(dev))
    build.check("dd_max_rows", rc)
    build.LAUNCHES["dd_max_rows"] += 1
    return out


def dd_max_rows2_cuda(mt: torch.Tensor, st: torch.Tensor):
    """Both sides of the Eqns 7-8 a-interval of (rows, t) float32 rows in
    one launch: ``(dd_max_rows(mt, st), -dd_max_rows(-st, -mt))``, i.e.
    ``max_{x<y} (mt[y]-st[x])/(y-x)`` and ``-max_{x<y} (mt[x]-st[y])/(y-x)``;
    -3.4e38 and 3.4e38 where t < 2."""
    mc, sc = _dd_rows(mt, st)
    (rows, t), dev = mc.shape, mc.device
    a_lo, a_hi = _dd_out(2, rows, t, dev)
    if rows == 0 or t < 2:
        return a_lo, a_hi
    rc = build.load().repro_dd_max_rows2(
        mc.data_ptr(), sc.data_ptr(), rows, t, a_lo.data_ptr(),
        a_hi.data_ptr(), dev.index or 0, build.stream_of(dev))
    build.check("dd_max_rows", rc)
    build.LAUNCHES["dd_max_rows"] += 1
    return a_lo, a_hi
