"""CUDA wrappers of the §II envelope kernels (``csrc/dspace.cu``), the port
of ``repro/kernels/dspace/kernel.py``.

``envelopes_parity_cuda``, ``envelopes_parity_batched_cuda`` and
``envelopes_parity_fleet_cuda`` replace the reference's three
``pallas_call`` sites (``envelopes_parity``, ``envelopes_parity_batched``,
``envelopes_parity_fleet``); all three launch the one ``(rows, n)`` kernel
and count under the reference's names. The reference's ``TILE``, its 3n
zero padding and its pad lanes are TPU layout: the kernel masks the row's
ends instead, so it takes any n and any row count. ``dd_max_rows_cuda`` is
the Eqns 7-8 a-interval reduction (``repro/kernels/dspace/ops.py``
``_dd_max_rows``, jnp glue in the reference, no Pallas kernel).
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


def dd_max_rows_cuda(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-wise ``max_{x<y} (g[y]-h[x])/(y-x)`` of (rows, t) float32 rows;
    -3.4e38 where t < 2."""
    _check(g, "dd_max_rows")
    _check(h, "dd_max_rows")
    if g.dim() != 2 or g.shape != h.shape or g.device != h.device:
        raise ValueError(f"dd_max_rows: g {tuple(g.shape)} on {g.device}, "
                         f"h {tuple(h.shape)} on {h.device}")
    rows, t = g.shape
    gc, hc = g.contiguous(), h.contiguous()
    dev = gc.device
    out = torch.full((rows,), -BIG, dtype=torch.float32, device=dev)
    if rows == 0 or t < 2:  # no pair: the reference's empty-loop value
        return out
    rc = build.load().repro_dd_max_rows(
        gc.data_ptr(), hc.data_ptr(), rows, t, out.data_ptr(),
        dev.index or 0, build.stream_of(dev))
    build.check("dd_max_rows", rc)
    build.LAUNCHES["dd_max_rows"] += 1
    return out
