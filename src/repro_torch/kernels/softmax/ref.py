"""Plain PyTorch versions of the fused softmax (twins of
``repro/kernels/softmax/ref.py`` ``fused_softmax_ref``, the per-table
kernel's, and ``fused_softmax_lib_ref``, the library-bound one's). The
per-table version reads each table from its design's own (2^R, 3) rows; the
library version from the port's library ROM, where a segmented (ROM v2)
slot decodes through ``interp_eval_seg_ref`` (``lut_rom_ref`` routes on the
meta's ``eval["seg"]``), as the reference's ``lut`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.interp.ref import (LOG2E, lut_rom_ref, pow2,
                                            table_recip)


def softmax_exp(x: torch.Tensor, coeffs: torch.Tensor, exp_meta: dict):
    """The exp half of the fused softmax over the last axis (``coeffs`` and
    ``exp_meta`` as in :func:`fused_softmax_ref`): returns the
    exp2neg table codes (int32) and the terms e (float32), with
    t = min((max - x) * log2e, 126) and e = tab(code(frac t)) *
    2^-out_bits * 2^-floor(t) in the reference's operation order."""
    xf = x.to(torch.float32)
    m = torch.amax(xf, dim=-1, keepdim=True)
    t = torch.clamp((m - xf) * LOG2E, max=126.0)
    n = torch.floor(t)
    eb = exp_meta["in_bits"]
    codes = torch.clamp(torch.round((t - n) * (1 << eb)).to(torch.int32), 0,
                        (1 << eb) - 1)
    tab = lut_rom_ref(codes, coeffs, exp_meta).to(torch.float32)
    return codes, tab * (2.0 ** -exp_meta["out_bits"]) * pow2(-n)


def fused_softmax_ref(x: torch.Tensor, exp_coeffs: torch.Tensor,
                      recip_coeffs: torch.Tensor, exp_meta: dict,
                      recip_meta: dict) -> torch.Tensor:
    """x: (rows, D) (or any leading shape); the exp table read from
    ``exp_coeffs``, the row sum's reciprocal from its IEEE-754 split and
    ``recip_coeffs``. Each operand is one design's (2^R, 3) rows (metas
    from ``softmax.ops._meta``) or the padded (F, R_max, 3) library ROM
    (metas from ``lib_meta``). Output in x's dtype."""
    _, e = softmax_exp(x, exp_coeffs, exp_meta)
    s = torch.sum(e, dim=-1, keepdim=True)
    return (e * table_recip(s, recip_coeffs, recip_meta)).to(x.dtype)


def fused_softmax_lib_ref(x: torch.Tensor, coeffs: torch.Tensor,
                          exp_meta: dict, recip_meta: dict) -> torch.Tensor:
    """Both tables read at their static func ids in the padded (F, R_max,
    3) ROM, then the per-table glue: bit-identical to
    :func:`fused_softmax_ref` on the designs the ROM packs."""
    return fused_softmax_ref(x, coeffs, coeffs, exp_meta, recip_meta)


def kernel_row_sum(e: torch.Tensor, vec: int, tpr: int) -> torch.Tensor:
    """The CUDA kernels' row sum of e ((rows, D) float32) in their order,
    for chunks of ``vec`` elements and ``tpr`` threads per row (``softmax/
    kernel.py`` ``launch_shape``): thread t adds the elements of chunks t,
    t + tpr, t + 2 tpr, ... in index order, a warp's threads are summed by
    an xor butterfly (each step adds the partner's value to its own, so
    every lane keeps lane 0's bits), then a row's warp partials by the same
    butterfly over 32 lanes (zeros past the row's warps). Returns (rows,)
    float32, on e's device. The CPU tests hold it against the reference's
    sum; the card tests hold the kernels bitwise against
    :func:`kernel_order_softmax`."""
    rows, d = e.shape
    per_pass = vec * tpr
    passes = max(1, -(-d // per_pass))
    kw = dict(dtype=torch.float32, device=e.device)
    padded = torch.zeros(rows, passes * per_pass, **kw)
    padded[:, :d] = e  # zeros after a thread's last element add nothing
    chunks = padded.view(rows, passes, tpr, vec)
    acc = torch.zeros(rows, tpr, **kw)
    for p in range(passes):
        for j in range(vec):
            acc = acc + chunks[:, p, :, j]
    width = min(tpr, 32)
    warps = _butterfly(acc.view(rows, tpr // width, width))
    if tpr <= 32:
        return warps[:, 0]
    lanes = torch.zeros(rows, 32, **kw)
    lanes[:, :warps.shape[1]] = warps
    return _butterfly(lanes)


def kernel_order_softmax(x: torch.Tensor, exp_coeffs: torch.Tensor,
                         recip_coeffs: torch.Tensor, exp_meta: dict,
                         recip_meta: dict, vec: int,
                         tpr: int) -> torch.Tensor:
    """:func:`fused_softmax_ref` on x (rows, D) with the row sum in the CUDA
    kernels' order (:func:`kernel_row_sum`): the kernels' output, bit for
    bit, at that launch shape."""
    _, e = softmax_exp(x, exp_coeffs, exp_meta)
    s = kernel_row_sum(e, vec, tpr)[:, None]
    return (e * table_recip(s, recip_coeffs, recip_meta)).to(x.dtype)


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """Lane 0 of an xor-shuffle sum over the last axis (a power of two):
    at each step lane l adds lane l + half."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def approx_softmax_library_ref(x: torch.Tensor, library) -> torch.Tensor:
    """The plain version at the wrapper's signature: softmax over the last
    axis of any leading shape."""
    from repro_torch.kernels.interp.ops import lib_meta

    return fused_softmax_lib_ref(x, library.coeffs,
                                 lib_meta(library, "exp2neg"),
                                 lib_meta(library, "recip"))
