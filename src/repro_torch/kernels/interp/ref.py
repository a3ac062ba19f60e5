"""Plain PyTorch versions of the Figure-1 datapath (twins of
``repro/kernels/interp/ref.py`` and of the in-kernel ``poly_tail`` /
``_lut_rom`` / ``_table_exp_neg`` / ``_table_recip``).

The reference computes in int32 with wrapping multiply-adds and logical
shifts; torch's ``>>`` is arithmetic, so these twins compute in int64 on the
uint32 view of each code and wrap the accumulator to two's-complement int32
before the arithmetic shift by k. The float glue mirrors the reference's
operation order and takes powers of two exactly (:func:`pow2`), where the
reference's ``exp2`` stands.
"""
from __future__ import annotations

import torch

LOG2E = 1.4426950408889634
_U32 = 0xFFFFFFFF


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its two's-complement int32 value (still int64)."""
    return ((x + 2**31) & _U32) - 2**31


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^e for integer-valued e in [-149, 127], built from the
    float64 bit pattern (no exp2 approximation, subnormals kept)."""
    bits = (e.to(torch.int64) + 1023) << 52
    return bits.view(torch.float64).to(torch.float32)


def poly_tail(a, b, c, x, k, sq, lin, degree) -> torch.Tensor:
    """Truncated square/linear terms, wrapped int32 Horner, >> k; int64
    tensors in, int32 out (scalars broadcast)."""
    xs = (x >> sq) << sq
    xl = (x >> lin) << lin
    xs = torch.where(torch.as_tensor(degree) == 2, xs, torch.zeros_like(xs))
    acc = wrap_i32(a * xs * xs + b * xl + c)
    return (acc >> k).to(torch.int32)


def library_eval_ref(codes: torch.Tensor, fids: torch.Tensor,
                     coeffs: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Gather-semantics twin of ``library_eval_ref``: element i evaluates
    function fids[i]. coeffs: (F, R_max, 3) int32; meta: (F, 5) int32 rows
    of (eval_bits, k, sq_trunc, lin_trunc, degree). Out-of-range indices
    clamp, as the reference's gathers do."""
    f, r_max, _ = coeffs.shape
    u = codes.to(torch.int64) & _U32
    fid = fids.to(torch.int64).clamp(0, f - 1)
    m = meta.to(torch.int64)[fid]
    eb, k, sq, lin, deg = m.unbind(-1)
    r = (u >> eb).clamp(max=r_max - 1)
    x = u & ((1 << eb) - 1)
    sel = coeffs.to(torch.int64)[fid, r]
    return poly_tail(sel[..., 0], sel[..., 1], sel[..., 2], x, k, sq, lin,
                     deg)


def interp_eval_ref(codes: torch.Tensor, coeffs: torch.Tensor, *,
                    eval_bits: int, k: int, sq_trunc: int, lin_trunc: int,
                    degree: int) -> torch.Tensor:
    """One design's Figure-1 evaluation on its (2^R, 3) int32 coefficients
    (twin of the reference's ``interp_eval_ref``): region = code >>
    eval_bits (clamped, as the reference's gather), then the int32 tail."""
    u = codes.to(torch.int64) & _U32
    r = (u >> eval_bits).clamp(max=coeffs.shape[0] - 1)
    x = u & ((1 << eval_bits) - 1)
    sel = coeffs.to(torch.int64)[r]
    return poly_tail(sel[..., 0], sel[..., 1], sel[..., 2], x, k, sq_trunc,
                     lin_trunc, degree)


def interp_eval_wide(codes: torch.Tensor, coeffs_wide: torch.Tensor, *,
                     eval_bits: int, k: int, sq_trunc: int, lin_trunc: int,
                     degree: int) -> torch.Tensor:
    """Exact evaluation of a design whose coefficients exceed int32, in
    native int64 on the codes' device (the reference emulates int64 with
    word pairs because its jax runs with x64 off): ``coeffs_wide`` is the
    (2^R, 3) int64 ``TableDesign.device_coeffs_wide``. Bit-identical to
    ``TableDesign.eval_int`` for any design whose accumulator fits int64;
    the result is the low 32 bits, as the reference's."""
    u = codes.to(torch.int64) & _U32
    r = (u >> eval_bits).clamp(max=coeffs_wide.shape[0] - 1)
    x = u & ((1 << eval_bits) - 1)
    xs = (x >> sq_trunc) << sq_trunc
    xl = (x >> lin_trunc) << lin_trunc
    sel = coeffs_wide[r]
    acc = sel[..., 1] * xl + sel[..., 2]
    if degree == 2:
        acc = acc + sel[..., 0] * xs * xs
    return (acc >> k).to(torch.int32)


def lut_rom_ref(codes: torch.Tensor, coeffs: torch.Tensor,
                meta: dict) -> torch.Tensor:
    """One function's table read from the padded ROM (static func id in
    ``meta``): the twin of ``interp_eval_ref`` on the slot's 2^R rows."""
    ev = meta["eval"]
    rows = coeffs[meta["fid"], : 1 << (meta["in_bits"] - ev["eval_bits"])]
    return interp_eval_ref(codes, rows, eval_bits=ev["eval_bits"], k=ev["k"],
                           sq_trunc=ev["sq_trunc"], lin_trunc=ev["lin_trunc"],
                           degree=ev["degree"])


def table_exp_neg(t: torch.Tensor, coeffs, meta: dict) -> torch.Tensor:
    """2^(-t) for t >= 0 via the exp2neg table (exact power-of-2 scale)."""
    t = torch.clamp(t, max=126.0)
    n = torch.floor(t)
    frac = t - n
    eb = meta["in_bits"]
    codes = torch.clamp(torch.round(frac * (1 << eb)).to(torch.int32),
                        0, (1 << eb) - 1)
    tab = lut_rom_ref(codes, coeffs, meta).to(torch.float32)
    return tab * (2.0 ** -meta["out_bits"]) * pow2(-n)


def table_recip(s: torch.Tensor, coeffs, meta: dict) -> torch.Tensor:
    """1/s for s > 0 via the IEEE-754 mantissa split + reciprocal table."""
    bits = s.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
    expo = ((bits >> 23) & 255) - 127
    mant = bits & ((1 << 23) - 1)
    rb = meta["in_bits"]
    half = 1 << (23 - rb - 1)
    rcodes = torch.clamp((mant + half) >> (23 - rb), 0, (1 << rb) - 1)
    rtab = lut_rom_ref(rcodes, coeffs, meta).to(torch.float32)
    return rtab * (2.0 ** -(rb + 1)) * pow2(-expo)
