"""Public wrappers of the Figure-1 datapath (twin of
``repro/kernels/interp/ops.py``): the CUDA kernel for CUDA tensors, the plain
version for CPU tensors. A CUDA tensor never falls back to the plain
version."""
from __future__ import annotations

import torch

from repro_torch.kernels.interp.kernel import library_eval_cuda
from repro_torch.kernels.interp.ref import library_eval_ref


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


def lib_meta(library, kind: str) -> dict:
    """The reference's per-slot meta dict (``repro.kernels.softmax.ops.
    lib_meta``): widths, static func id and the datapath row."""
    m = library.meta(kind)
    return {
        "in_bits": m.in_bits,
        "out_bits": m.out_bits,
        "fid": library.func_id(kind),
        "eval": {"eval_bits": m.eval_bits, "k": m.k, "sq_trunc": m.sq_trunc,
                 "lin_trunc": m.lin_trunc, "degree": m.degree},
    }
