"""Public wrappers of the Figure-1 datapath (twin of
``repro/kernels/interp/ops.py``): the CUDA kernel for CUDA tensors, the plain
version for CPU tensors. A CUDA tensor never falls back to the plain
version."""
from __future__ import annotations

import torch

from repro_torch.core.table import TableDesign
from repro_torch.kernels.interp.kernel import (act_library_cuda,
                                               interp_eval_cuda,
                                               library_eval_cuda,
                                               library_walk_cuda,
                                               rom_eval_cuda)
from repro_torch.kernels.interp.ref import (interp_eval_ref, interp_eval_wide,
                                            library_eval_ref,
                                            library_walk_ref, rom_eval_ref)


def table_eval(codes: torch.Tensor, design: TableDesign) -> torch.Tensor:
    """Evaluate ``design`` on int32 codes (any shape) on the codes' device.

    Designs whose coefficients exceed int32 (wide-output reciprocals, the
    16-bit Table I designs) take the int64 wide path, plain torch on the
    codes' device (in the reference that path is jnp code, not a Pallas
    kernel); any other design takes the ``interp_eval`` kernel on CUDA and
    its plain version on the CPU."""
    codes = codes.to(torch.int32)
    dp = dict(eval_bits=design.eval_bits, k=design.k,
              sq_trunc=design.sq_trunc, lin_trunc=design.lin_trunc,
              degree=design.degree)
    if not design.fits_int32:
        return interp_eval_wide(codes, design.device_coeffs_wide(codes.device),
                                **dp)
    coeffs = design.device_coeffs(codes.device)
    if codes.is_cuda:
        return interp_eval_cuda(codes, coeffs, **dp)
    return interp_eval_ref(codes, coeffs, **dp)


def library_eval(codes: torch.Tensor, fids, coeffs: torch.Tensor,
                 meta: torch.Tensor) -> torch.Tensor:
    """Fused multi-function evaluation: element i reads function
    ``fids[i]``'s table row (``fids`` may be one id for every element).

    codes: int32, any shape (values in [0, 2^in_bits)); coeffs: (F, R_max,
    3) int32 padded ROM; meta: (F, 5) int32 datapath rows."""
    codes = codes.to(torch.int32)
    if codes.is_cuda:
        return library_eval_cuda(codes, fids, coeffs, meta)
    fids = torch.as_tensor(fids, dtype=torch.int32).expand(codes.shape)
    return library_eval_ref(codes, fids, coeffs, meta)


def library_walk(codes: torch.Tensor, fids, coeffs: torch.Tensor,
                 walk: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """Fused evaluation over a mixed uniform/segmented library: element i
    walks function ``fids[i]``'s slot whatever its layout (``fids`` may be
    one id for every element).

    codes: int32, any shape; coeffs: (F, R_max, 3) int32 padded ROM; walk:
    (F, 5) int32; dp: (L, 5) int32 (``InterpLibrary.walk_rows()``)."""
    codes = codes.to(torch.int32)
    if codes.is_cuda:
        return library_walk_cuda(codes, fids, coeffs, walk, dp)
    fids = torch.as_tensor(fids, dtype=torch.int32).expand(codes.shape)
    return library_walk_ref(codes, fids, coeffs, walk, dp)


def act_library(x: torch.Tensor, library, kind: str) -> torch.Tensor:
    """The served activation ``kind`` (silu, sigmoid, softplus, gelu, tanh)
    of ``library`` on x of any shape, in x's dtype: one ``act_lib`` launch
    for a CUDA x (bfloat16 or float32), the float glue around the plain
    table read (``PlainFusedNumerics._act``) for a CPU x."""
    if x.is_cuda:
        return act_library_cuda(x, library, kind)
    from repro_torch.numerics.ops import PlainFusedNumerics

    return PlainFusedNumerics(library)._act(kind, x)


def rom_eval(codes: torch.Tensor, library, kind: str) -> torch.Tensor:
    """``kind``'s slot of ``library``'s flat ROM through the in-kernel
    table read (the ``rom_eval_2d`` golden harness): the ``rom_eval``
    kernel for CUDA codes, ``rom_eval_ref`` for CPU codes."""
    codes = codes.to(torch.int32)
    if codes.is_cuda:
        return rom_eval_cuda(codes, library, kind)
    m = library.meta(kind)
    return rom_eval_ref(codes, library.coeffs.reshape(-1, 3),
                        fid=library.func_id(kind), r_max=library.r_max,
                        eval_bits=m.eval_bits, k=m.k, sq_trunc=m.sq_trunc,
                        lin_trunc=m.lin_trunc, degree=m.degree,
                        seg=m.seg_spec())


def lib_meta(library, kind: str) -> dict:
    """The reference's per-slot meta dict (``repro.kernels.softmax.ops.
    lib_meta``): widths, static func id and the datapath row; a segmented
    slot also carries its ``seg_spec()`` under ``eval["seg"]``, which
    routes the plain versions through the segment-index datapath."""
    m = library.meta(kind)
    ev = {"eval_bits": m.eval_bits, "k": m.k, "sq_trunc": m.sq_trunc,
          "lin_trunc": m.lin_trunc, "degree": m.degree}
    if m.segmented:
        ev["seg"] = m.seg_spec()
    return {
        "in_bits": m.in_bits,
        "out_bits": m.out_bits,
        "fid": library.func_id(kind),
        "eval": ev,
    }
