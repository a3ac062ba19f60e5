"""CUDA wrappers of ``library_eval``, ``library_walk``, ``act_lib``,
``rom_eval`` and ``interp_eval`` (``csrc/interp.cu``), the ports of
``repro/kernels/interp/kernel.py`` ``library_eval_2d`` /
``_library_kernel``, ``library_walk_2d`` / ``_library_walk_kernel``,
``rom_eval_2d`` / ``_rom_kernel`` and ``interp_eval_2d`` /
``_interp_kernel``; ``act_lib`` is the served activation, the reference's
float glue (``repro/numerics/ops.py`` ``_range_glue`` / ``_act_tails``)
around ``library_eval_2d`` or ``library_walk_2d``, in one kernel.

The reference tiles codes as (rows, 128) lanes with rows % 8 and reads the
ROM by one-hot MXU contractions; on Hopper the kernel takes any shape
flattened, stages the ROM (or the one slot a call reads, under the first
loads of codes) in shared memory and reads it by index; one design's rows
past a block's shared memory are read in place."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build


def _fid_operand(fids, codes: torch.Tensor, n_funcs: int):
    """(pointer, fid0, tensor) of the function-id operand: (None, id, None)
    for one id for every element, else the per-element int32 tensor's
    pointer, 0 and the tensor itself (the caller keeps it alive across the
    launch)."""
    if isinstance(fids, int) or fids.numel() == 1:
        fid0 = int(fids)
        if not 0 <= fid0 < n_funcs:
            raise ValueError(f"function id {fid0} outside [0, {n_funcs})")
        return None, fid0, None
    if fids.shape != codes.shape or fids.dtype != torch.int32:
        raise ValueError("fids must be int32 of the codes' shape")
    if fids.device != codes.device:
        raise ValueError(f"operands on {fids.device} and {codes.device}")
    fids = fids.contiguous()
    return fids.data_ptr(), 0, fids


def _check_operands(codes: torch.Tensor, *tables: torch.Tensor) -> None:
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {codes.dtype}")
    for t in tables:
        if t.dtype != torch.int32:
            raise TypeError(f"ROM operands must be int32, got {t.dtype}")
        if t.device != codes.device:
            raise ValueError(f"operands on {t.device} and {codes.device}")


def library_eval_cuda(codes: torch.Tensor, fids: torch.Tensor | int,
                      coeffs: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """codes: int32 CUDA tensor, any shape; fids: one function id for every
    element (int or one-element tensor) or an int32 tensor of the codes'
    shape; coeffs: (F, R_max, 3) int32; meta: (F, 5) int32."""
    dev = codes.device
    _check_operands(codes, coeffs, meta)
    f, r_max, three = coeffs.shape
    if three != 3 or tuple(meta.shape) != (f, 5):
        raise ValueError(f"bad ROM {tuple(coeffs.shape)} / meta "
                         f"{tuple(meta.shape)}")
    codes = codes.contiguous()
    fid_ptr, fid0, _keep = _fid_operand(fids, codes, f)
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


def library_walk_cuda(codes: torch.Tensor, fids: torch.Tensor | int,
                      coeffs: torch.Tensor, walk: torch.Tensor,
                      dp: torch.Tensor) -> torch.Tensor:
    """The port of ``library_walk_2d``: codes int32, any shape; fids as in
    :func:`library_eval_cuda`; coeffs: (F, R_max, 3) int32; walk: (F, 5)
    int32 (in_bits, depth, seg_flag, leaf_base, n_leaves) rows; dp: (L, 5)
    int32 datapath rows (``InterpLibrary.walk_rows()``)."""
    dev = codes.device
    _check_operands(codes, coeffs, walk, dp)
    f, r_max, three = coeffs.shape
    if three != 3 or tuple(walk.shape) != (f, 5) or dp.dim() != 2 \
            or dp.shape[1] != 5:
        raise ValueError(f"bad ROM {tuple(coeffs.shape)} / walk "
                         f"{tuple(walk.shape)} / dp {tuple(dp.shape)}")
    codes = codes.contiguous()
    fid_ptr, fid0, _keep = _fid_operand(fids, codes, f)
    coeffs, walk, dp = coeffs.contiguous(), walk.contiguous(), dp.contiguous()
    out = torch.empty_like(codes)
    rc = build.load().repro_library_walk(
        codes.data_ptr(), fid_ptr, fid0, coeffs.data_ptr(), walk.data_ptr(),
        dp.data_ptr(), f, r_max, dp.shape[0], out.data_ptr(), codes.numel(),
        dev.index or 0, build.stream_of(dev))
    build.check("library_walk", rc)
    build.LAUNCHES["library_walk"] += 1
    return out


@functools.lru_cache(maxsize=64)
def _act_operands(library, kind: str, dtype: torch.dtype):
    """(slot row, glue constants, top_is_x) of ``act_lib`` for ``kind``'s
    slot of ``library`` and an x of ``dtype``: the constants the glue
    rounds once, in its order (``repro_torch.numerics.ops._range_glue`` /
    ``_act_tails``)."""
    from repro_torch.numerics.ops import act_tail_values

    m = library.meta(kind)
    if not m.act_span:
        raise ValueError(f"{kind!r} is not an activation slot")
    lo, hi = m.act_lo, m.act_hi

    def f32(v: float) -> float:
        return float(np.float32(v))

    def in_dtype(v: float) -> float:  # the tails compare in x's dtype
        return float(torch.tensor(v, dtype=torch.float64).to(dtype))

    top, bot = act_tail_values(kind)
    glue = [f32(lo), f32(hi - 1e-6), f32(hi - lo),
            f32(m.act_span / (1 << m.out_bits)), in_dtype(lo), in_dtype(hi),
            0.0 if top is None else top, bot]
    return (build.int_array(slot_args(library, kind)),
            build.int_array(glue, ctypes.c_float), int(top is None))


def act_rows(x: torch.Tensor) -> tuple[torch.Tensor, int, int, int]:
    """``x`` and the (rows, cols, row stride) ``act_lib`` reads it as, in
    elements: one row for a contiguous x; rows at one stride for a view
    whose last dim is contiguous and whose outer dims merge, as the gate
    half of a SwiGLU product (``torch.chunk(h, 2, -1)[0]``, stride 2 *
    cols); any other layout is copied contiguous first."""
    if not x.is_contiguous() and x.dim() and x.stride(-1) == 1:
        try:
            rows = x.view(-1, x.shape[-1])
        except RuntimeError:  # outer dims that do not merge
            rows = None
        if rows is not None and rows.shape[0] > 1:
            return x, rows.shape[0], rows.shape[1], rows.stride(0)
    x = x.contiguous()
    return x, 1, x.numel(), x.numel()


_ACT_BODIES = {None: -1, "datapath": 0, "table": 1}


def act_library_cuda(x: torch.Tensor, library, kind: str, *,
                     body: str | None = None) -> torch.Tensor:
    """The served activation ``kind`` of ``library`` on a bf16 or float32
    CUDA tensor of any shape, in one ``act_lib`` launch: bitwise the float
    glue of ``InterpNumerics._act`` around ``library.eval_int``. A row
    strided x (:func:`act_rows`) is read in place; the result is
    contiguous. ``body`` forces the per-element datapath (``"datapath"``)
    or the table of outputs (``"table"``); by default the kernel takes the
    table from 16 elements per code on a segmented slot, 384 on a uniform
    one."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"act_lib takes bfloat16 or float32, got {x.dtype}")
    dev = x.device
    if library.device != dev:
        raise ValueError(f"operands on {library.device} and {dev}")
    slot, glue, top_is_x = _act_operands(library, kind, x.dtype)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    if x.numel() == 0:
        return out
    x, rows, cols, stride = act_rows(x)
    rc = build.load().repro_act_lib(
        x.data_ptr(), out.data_ptr(), rows, cols, stride,
        int(x.dtype == torch.bfloat16), library.coeffs.data_ptr(), slot,
        library.walk_rows()[1].data_ptr(), glue, top_is_x, _ACT_BODIES[body],
        dev.index or 0, build.stream_of(dev))
    build.check("act_lib", rc)
    build.LAUNCHES["act_lib"] += 1
    return out


def rom_eval_cuda(codes: torch.Tensor, library, kind: str) -> torch.Tensor:
    """The port of ``rom_eval_2d``: ``kind``'s slot of ``library``'s ROM on
    int32 codes of any shape, through the ``lut_slot`` read the fused
    kernels inline (the segmented one for a v2 slot)."""
    dev = codes.device
    rom = library.coeffs
    _check_operands(codes, rom)
    dp = library.walk_rows()[1]
    codes = codes.contiguous()
    out = torch.empty_like(codes)
    if codes.numel() == 0:
        return out
    rc = build.load().repro_rom_eval(
        codes.data_ptr(), rom.data_ptr(),
        build.int_array(slot_args(library, kind)), dp.data_ptr(),
        out.data_ptr(), codes.numel(), dev.index or 0, build.stream_of(dev))
    build.check("rom_eval", rc)
    build.LAUNCHES["rom_eval"] += 1
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
    row = [0, coeffs.shape[0], eval_bits, k, sq_trunc, lin_trunc, degree,
           0, 0, 0, 0, 0]  # design_args' layout; the widths go unread
    rc = build.load().repro_interp_eval(
        codes.data_ptr(), coeffs.data_ptr(), build.int_array(row),
        out.data_ptr(), codes.numel(), dev.index or 0, build.stream_of(dev))
    build.check("interp_eval", rc)
    build.LAUNCHES["interp_eval"] += 1
    return out


def design_args(design) -> list[int]:
    """The 12-int table row of one design's own (2^R, 3) coefficients, the
    per-table kernels' operand: row 0, its 2^R rows, its datapath row and
    widths, no segment table (the layout of :func:`slot_args`)."""
    return [0, len(design.a), design.eval_bits, design.k, design.sq_trunc,
            design.lin_trunc, design.degree, design.in_bits, design.out_bits,
            0, 0, 0]


def slot_args(library, kind: str) -> list[int]:
    """The 12-int table row the fused kernels take for one library slot:
    (first ROM row, slot rows, eval_bits, k, sq_trunc, lin_trunc, degree,
    in_bits, out_bits, seg_depth, n_leaves, leaf_base); the last three
    address a segmented slot's leaf rows in ``walk_rows()[1]`` (the
    reference's ``lib_meta`` carries them as ``eval["seg"]``), as the
    library's ``walk_table()`` lays them out."""
    fid = library.func_id(kind)
    m = library.metas[fid]
    *_, leaf_base, n_leaves = library.walk_table()[0][fid]
    return [fid * library.r_max, library.r_max, *m.datapath_row(), m.in_bits,
            m.out_bits, m.seg_depth, n_leaves, leaf_base]
