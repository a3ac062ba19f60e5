"""Plain PyTorch versions of the Figure-1 datapath (twins of
``repro/kernels/interp/ref.py`` and of the in-kernel ``poly_tail`` /
``_lut_rom`` / ``_lut_seg`` / ``_table_exp_neg`` / ``_table_recip``).

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


def library_walk_ref(codes: torch.Tensor, fids: torch.Tensor,
                     coeffs: torch.Tensor, walk: torch.Tensor,
                     dp: torch.Tensor) -> torch.Tensor:
    """Gather-semantics twin of ``library_walk_ref``: uniform (v1) and
    segmented (v2) slots in one call. coeffs: (F, R_max, 3) int32; walk:
    (F, 5) int32 rows of (in_bits, depth, seg_flag, leaf_base, n_leaves);
    dp: (L, 5) int32 (eval_bits, k, sq_trunc, lin_trunc, degree) rows, one
    per uniform function and one per segmented leaf.

    cell = code >> (in_bits - depth) (logical); a segmented element reads
    its leaf at entry ``(fid * r_max + n_leaves) * 3 + cell`` of the
    flattened ROM, a uniform element's leaf is its cell (and it reads that
    entry too, clamped in bounds, and discards it, as the reference does).
    Coefficients come from ROM row ``fid * r_max + leaf``, the datapath row
    from ``dp[leaf_base (+ leaf)]``. Every gather clamps its index, as the
    reference's do."""
    f, r_max, _ = coeffs.shape
    rom = coeffs.reshape(f * r_max, 3).to(torch.int64)
    entries = rom.reshape(-1)
    u = codes.to(torch.int64) & _U32
    fid = fids.to(torch.int64).clamp(0, f - 1)
    in_b, depth, segf, lbase, nlv = walk.to(torch.int64)[fid].unbind(-1)
    cell = u >> (in_b - depth)
    eidx = ((fid * r_max + nlv) * 3 + cell).clamp(0, entries.numel() - 1)
    seg = segf == 1
    leaf = torch.where(seg, entries[eidx], cell)
    sel = rom[(fid * r_max + leaf).clamp(0, f * r_max - 1)]
    drow = (lbase + torch.where(seg, leaf, torch.zeros_like(leaf)))
    eb, k, sq, lin, deg = dp.to(torch.int64)[
        drow.clamp(0, dp.shape[0] - 1)].unbind(-1)
    x = u & ((1 << eb) - 1)
    return poly_tail(sel[..., 0], sel[..., 1], sel[..., 2], x, k, sq, lin,
                     deg)


def interp_eval_seg_ref(codes: torch.Tensor, rows: torch.Tensor, *,
                        seg: tuple) -> torch.Tensor:
    """Twin of ``interp_eval_seg_ref``, the segmented (ROM v2) slot
    datapath. ``rows`` is one function's slot: ``[0, S)`` per-leaf
    coefficient triples, then the segment-index table packed 3 int32 per
    row; ``seg`` is ``FuncMeta.seg_spec()``, ``(in_bits, depth, n_leaves,
    leaf_meta)``. cell = top D bits of the code -> leaf -> the leaf's
    coefficients and (eval_bits, k, sq_trunc, lin_trunc, degree) -> the
    int32 tail. Out-of-range cells and leaves clamp, as the reference's
    gathers do."""
    in_bits, depth, n_leaves, leaf_meta = seg
    n_cells = 1 << depth
    n_table_rows = (n_cells + 2) // 3
    if n_leaves + n_table_rows > rows.shape[0] or len(leaf_meta) != n_leaves:
        raise ValueError(f"segment spec of {n_leaves} leaves at depth "
                         f"{depth} does not fit a slot of {rows.shape[0]} "
                         f"rows")
    rows = rows.to(torch.int64)
    seg_tab = rows[n_leaves:n_leaves + n_table_rows].reshape(-1)[:n_cells]
    u = codes.to(torch.int64) & _U32
    cell = (u >> (in_bits - depth)).clamp(max=n_cells - 1)
    leaf = seg_tab[cell].clamp(0, n_leaves - 1)
    meta = torch.tensor(leaf_meta, dtype=torch.int64, device=rows.device)
    eb, k, sq, lin, deg = meta[leaf].unbind(-1)
    x = u & ((1 << eb) - 1)
    sel = rows[:n_leaves][leaf]
    return poly_tail(sel[..., 0], sel[..., 1], sel[..., 2], x, k, sq, lin,
                     deg)


def rom_eval_ref(codes: torch.Tensor, rom: torch.Tensor, *, fid: int,
                 r_max: int, eval_bits: int, k: int, sq_trunc: int,
                 lin_trunc: int, degree: int,
                 seg: tuple | None = None) -> torch.Tensor:
    """The ``_lut_rom`` read of ``rom_eval_2d`` on one slot of a flattened
    ``(F * r_max, 3)`` ROM: rows ``[fid * r_max, (fid + 1) * r_max)``
    through the segmented datapath when ``seg`` is given (the per-call
    scalars are then unused, each leaf carries its own), else through the
    uniform one."""
    rows = rom[fid * r_max:(fid + 1) * r_max]
    if seg is not None:
        return interp_eval_seg_ref(codes, rows, seg=seg)
    return interp_eval_ref(codes, rows, eval_bits=eval_bits, k=k,
                           sq_trunc=sq_trunc, lin_trunc=lin_trunc,
                           degree=degree)


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
    """One function's table read: from the padded (F, R_max, 3) ROM at the
    static func id in ``meta`` (``interp_eval_seg_ref`` on the slot when
    ``meta["eval"]`` carries a ``seg`` spec, else ``interp_eval_ref`` on its
    2^R rows), or from one design's own (2^R, 3) rows, the per-table
    kernels' operand (``meta`` then has no func id)."""
    ev = meta["eval"]
    if coeffs.dim() == 2:
        rows = coeffs
    elif ev.get("seg") is not None:
        return interp_eval_seg_ref(codes, coeffs[meta["fid"]], seg=ev["seg"])
    else:
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
