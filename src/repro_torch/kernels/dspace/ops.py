"""Public wrappers of the §II envelope computation (twin of
``repro/kernels/dspace/ops.py``): the CUDA kernels for CUDA tensors, their
plain versions for CPU tensors. A CUDA tensor never falls back to the plain
version.

``envelopes_pallas`` returns M(t), m(t) in the exact layout the core numpy
path (``repro_torch.core.designspace.envelopes``) produces.
``region_envelopes_device`` is the ``pallas`` engine's front half: one
envelope-kernel launch over all ``2^R`` regions, then the parity merge and
Eqn 9 feasibility as torch ops on the device and both sides of the Eqns 7-8
a-interval as one launch of the ``dd_max_rows`` kernel.
``fleet_region_envelopes_device`` does the same over a stacked probe
fleet. Envelope arithmetic is float32 (DESIGN.md §9); results come back to
numpy float64 in the core layout (index 0 a placeholder, sentinels as
+/-inf).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels.dspace.kernel import (dd_max_rows2_cuda,
                                               dd_max_rows_cuda,
                                               envelopes_parity_batched_cuda,
                                               envelopes_parity_cuda,
                                               envelopes_parity_fleet_cuda)
from repro_torch.kernels.dspace.ref import (dd_max_rows2_ref, dd_max_rows_ref,
                                            envelopes_parity_ref)

# the fleet's +/-inf column sentinels become the reference's finite pad
# values, which lose every min/max reduction the same way
_PAD_L, _PAD_U = -(2.0 ** 30), 2.0 ** 30


def envelopes_parity(l_arr: torch.Tensor, u_arr: torch.Tensor):
    """(n,) float32 bounds -> (m_even, m_odd, M_even, M_odd), each (n,)."""
    if l_arr.is_cuda:
        return envelopes_parity_cuda(l_arr, u_arr)
    return tuple(o[0] for o in envelopes_parity_ref(l_arr[None], u_arr[None]))


def envelopes_parity_batched(l_arr: torch.Tensor, u_arr: torch.Tensor):
    """(B, n) float32 bounds -> four (B, n) parity envelopes."""
    if l_arr.is_cuda:
        return envelopes_parity_batched_cuda(l_arr, u_arr)
    return envelopes_parity_ref(l_arr, u_arr)


def envelopes_parity_fleet(l_arr: torch.Tensor, u_arr: torch.Tensor):
    """(P, B, n) float32 bounds -> four (P, B, n) parity envelopes."""
    if l_arr.is_cuda:
        return envelopes_parity_fleet_cuda(l_arr, u_arr)
    p, b, n = l_arr.shape
    outs = envelopes_parity_ref(l_arr.reshape(p * b, n),
                                u_arr.reshape(p * b, n))
    return tuple(o.reshape(p, b, n) for o in outs)


def dd_max_rows(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Row-wise ``max_{x<y} (g[y]-h[x])/(y-x)`` of (rows, t) float32."""
    if g.is_cuda:
        return dd_max_rows_cuda(g, h)
    return dd_max_rows_ref(g, h)


def dd_max_rows2(mt: torch.Tensor, st: torch.Tensor):
    """Both sides of the a-interval of (rows, t) float32 rows:
    ``(dd_max_rows(mt, st), -dd_max_rows(-st, -mt))``, one launch."""
    if mt.is_cuda:
        return dd_max_rows2_cuda(mt, st)
    return dd_max_rows2_ref(mt, st)


def _rows_f32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a, np.float64)
    a = np.where(np.isfinite(a), a, np.where(a > 0, _PAD_U, _PAD_L))
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _interleave(me, mo, be, bo):
    """(rows, n) parity tensors -> (M, m), (rows, 2n - 2) indexed by t;
    t = 2j reads the even slot of center j, t = 2j + 1 its odd slot."""
    rows, n = me.shape
    m = torch.stack([me[:, : n - 1], mo[:, : n - 1]], dim=2)
    big = torch.stack([be[:, : n - 1], bo[:, : n - 1]], dim=2)
    return big.reshape(rows, 2 * n - 2), m.reshape(rows, 2 * n - 2)


def _to_core(big: torch.Tensor, m: torch.Tensor):
    """Device float32 (M, m) rows -> numpy float64 in the core layout."""
    big = big.to(torch.float64).cpu().numpy()
    m = m.to(torch.float64).cpu().numpy()
    m[m >= 3.0e38] = np.inf
    big[big <= -3.0e38] = -np.inf
    m[:, 0] = np.inf
    big[:, 0] = -np.inf
    return big, m


def _one_row(L: np.ndarray, U: np.ndarray, device, parity
             ) -> tuple[np.ndarray, np.ndarray]:
    """``parity`` of one row of bounds on ``device``, as M(t), m(t) in the
    core layout; any n."""
    n = len(L)
    if n < 2:
        return np.full(1, -np.inf), np.full(1, np.inf)
    dev = resolve(device)
    out = parity(_rows_f32(L, dev), _rows_f32(U, dev))
    big, m = _to_core(*_interleave(*(o[None] for o in out)))
    return big[0], m[0]


def envelopes_pallas(L: np.ndarray, U: np.ndarray, device="cuda"
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Drop-in for ``core.designspace.envelopes`` through the one-row
    kernel (``envelopes_parity``) on ``device``; any n."""
    return _one_row(L, U, device, envelopes_parity)


def envelopes_ref_jnp(L: np.ndarray, U: np.ndarray, device="cpu"
                      ) -> tuple[np.ndarray, np.ndarray]:
    """``envelopes_pallas`` through the plain version on ``device``,
    whatever tensor it holds; the reference's name for the same
    baseline."""
    return _one_row(L, U, device, lambda l_row, u_row: tuple(
        o[0] for o in envelopes_parity_ref(l_row[None], u_row[None])))


def _merge_reduce(me, mo, be, bo):
    """On-device parity merge, Eqn 9 feasibility ``all(M[t] < m[t])`` and
    the Eqns 7-8 a-interval over (rows, n) parity rows."""
    big, m = _interleave(me, mo, be, bo)
    mt, st = big[:, 1:].contiguous(), m[:, 1:].contiguous()
    feas9 = torch.all(mt < st, dim=1)
    a_lo, a_hi = dd_max_rows2(mt, st)
    return big, m, a_lo, a_hi, feas9


def _results(big, m, a_lo, a_hi, feas9):
    big, m = _to_core(big, m)
    return (big, m, a_lo.to(torch.float64).cpu().numpy(),
            a_hi.to(torch.float64).cpu().numpy(), feas9.cpu().numpy())


def region_envelopes_device(L: np.ndarray, U: np.ndarray, device="cuda"
                            ) -> tuple[np.ndarray, ...]:
    """§II front half for ALL regions on ``device``: (M, m, a_lo, a_hi,
    feas9). L, U: (B, n) integer bounds, n >= 3."""
    L = np.asarray(L)
    U = np.asarray(U)
    b, n = L.shape
    if n < 3:
        raise ValueError("trivial region widths are handled by the numpy "
                         "engine")
    dev = resolve(device)
    parity = envelopes_parity_batched(_rows_f32(L, dev), _rows_f32(U, dev))
    return _results(*_merge_reduce(*parity))


def fleet_region_envelopes_device(L3, U3, shards: int | None = None,
                                  device="cuda", devices=None
                                  ) -> tuple[np.ndarray, ...]:
    """§II front half for a stacked probe fleet ``(P, B, N)``: the probe
    axis split into ``shards`` chunks, one launch of the fleet kernel per
    chunk over its (probe, region) rows, each chunk on its own entry of
    ``devices`` (default: every visible card for a CUDA ``device``, else
    ``device`` alone). ``shards`` is capped at the number of devices, as the
    reference caps it at its local device count; ``None`` / 1 is one
    program. A probe count ``shards`` does not divide is padded with
    sentinel probes (all bounds at the pad values), as the reference pads
    its shard axis. The chunks are launched before any result is read, so
    chunks on several cards overlap.

    Returns ``(M, m, a_lo, a_hi, feas9)`` flattened to probe-major rows
    ``(P*B, ...)`` in the core float64 layout: the chunks' rows
    concatenated, the sentinel probes' rows dropped. Every row is
    independent, so the result is the same for any ``shards``.
    """
    L3 = np.asarray(L3)
    U3 = np.asarray(U3)
    p, b, n = L3.shape
    if n < 3:
        raise ValueError("trivial region widths are handled by the numpy "
                         "engine")
    if shards is not None and shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    dev = resolve(device)
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devices = [resolve(d) for d in devices] or [dev]
    shards = 1 if shards is None else min(int(shards), len(devices))
    per = -(-p // shards)
    if per * shards > p:  # sentinel probes pad the shard axis
        pad = ((0, per * shards - p), (0, 0), (0, 0))
        L3 = np.pad(L3.astype(np.float64), pad, constant_values=-np.inf)
        U3 = np.pad(U3.astype(np.float64), pad, constant_values=np.inf)
    parts = []
    for k in range(shards):
        d, sl = devices[k], slice(k * per, (k + 1) * per)
        parity = envelopes_parity_fleet(_rows_f32(L3[sl], d),
                                        _rows_f32(U3[sl], d))
        parts.append(_merge_reduce(*(o.reshape(per * b, n)
                                     for o in parity)))
    outs = [_results(*part) for part in parts]
    return tuple(np.concatenate(col)[:p * b] for col in zip(*outs))
