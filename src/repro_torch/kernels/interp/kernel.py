"""CUDA wrappers of ``library_eval`` and ``interp_eval``
(``csrc/interp.cu``), the ports of ``repro/kernels/interp/kernel.py``
``library_eval_2d`` / ``_library_kernel`` and ``interp_eval_2d`` /
``_interp_kernel``.

The reference tiles codes as (rows, 128) lanes with rows % 8 and reads the
ROM by one-hot MXU contractions; on Hopper the kernel takes any shape
flattened, stages the ROM in shared memory and reads it by index.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def library_eval_cuda(codes: torch.Tensor, fids: torch.Tensor | int,
                      coeffs: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """codes: int32 CUDA tensor, any shape; fids: one function id for every
    element (int or one-element tensor) or an int32 tensor of the codes'
    shape; coeffs: (F, R_max, 3) int32; meta: (F, 5) int32."""
    dev = codes.device
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {codes.dtype}")
    if coeffs.dtype != torch.int32 or meta.dtype != torch.int32:
        raise TypeError("coeffs and meta must be int32")
    f, r_max, three = coeffs.shape
    if three != 3 or tuple(meta.shape) != (f, 5):
        raise ValueError(f"bad ROM {tuple(coeffs.shape)} / meta "
                         f"{tuple(meta.shape)}")
    codes = codes.contiguous()
    operands = [coeffs, meta]
    if isinstance(fids, int) or fids.numel() == 1:
        fid_ptr, fid0 = None, int(fids)
        if not 0 <= fid0 < f:
            raise ValueError(f"function id {fid0} outside [0, {f})")
    else:
        if fids.shape != codes.shape or fids.dtype != torch.int32:
            raise ValueError("fids must be int32 of the codes' shape")
        fids = fids.contiguous()
        operands.append(fids)
        fid_ptr, fid0 = fids.data_ptr(), 0
    for t in operands:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
    coeffs, meta = coeffs.contiguous(), meta.contiguous()
    out = torch.empty_like(codes)
    lib = build.load()
    rc = lib.repro_library_eval(
        codes.data_ptr(), fid_ptr, fid0, coeffs.data_ptr(), meta.data_ptr(),
        f, r_max, out.data_ptr(), codes.numel(), dev.index or 0,
        build.stream_of(dev))
    build.check("library_eval", rc)
    build.LAUNCHES["library_eval"] += 1
    return out


def interp_eval_cuda(codes: torch.Tensor, coeffs: torch.Tensor, *,
                     eval_bits: int, k: int, sq_trunc: int, lin_trunc: int,
                     degree: int) -> torch.Tensor:
    """The port of ``interp_eval_2d`` / ``_interp_kernel``: one design's
    (2^R, 3) int32 coefficients on int32 codes of any shape (the reference
    needs (rows % 8, 128) tiles)."""
    if codes.dtype != torch.int32 or coeffs.dtype != torch.int32:
        raise TypeError(f"codes and coeffs must be int32, got {codes.dtype}"
                        f" and {coeffs.dtype}")
    if coeffs.dim() != 2 or coeffs.shape[1] != 3:
        raise ValueError(f"coeffs must be (2^R, 3), got "
                         f"{tuple(coeffs.shape)}")
    if coeffs.device != codes.device:
        raise ValueError(f"operands on {coeffs.device} and {codes.device}")
    if not all(0 <= v < 32 for v in (eval_bits, k, sq_trunc, lin_trunc)):
        raise ValueError("datapath shifts must lie in [0, 32)")
    dev = codes.device
    codes, coeffs = codes.contiguous(), coeffs.contiguous()
    out = torch.empty_like(codes)
    if codes.numel() == 0:
        return out
    rc = build.load().repro_interp_eval(
        codes.data_ptr(), coeffs.data_ptr(), coeffs.shape[0], eval_bits, k,
        sq_trunc, lin_trunc, degree, out.data_ptr(), codes.numel(),
        dev.index or 0, build.stream_of(dev))
    build.check("interp_eval", rc)
    build.LAUNCHES["interp_eval"] += 1
    return out


def slot_args(library, kind: str) -> list[int]:
    """The 9-int table row the fused kernels take for one library slot:
    (first ROM row, slot rows, eval_bits, k, sq_trunc, lin_trunc, degree,
    in_bits, out_bits)."""
    m = library.meta(kind)
    return [library.func_id(kind) * library.r_max, library.r_max,
            *m.datapath_row(), m.in_bits, m.out_bits]
