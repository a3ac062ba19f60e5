"""Fused softmax over the last axis (twin of ``repro/kernels/softmax/ops.py``):
per-table (``approx_softmax_fused``, one design per table) or library-bound
(``approx_softmax_library``, one ROM for both). The CUDA kernel for CUDA
tensors, always; the plain version for CPU tensors. Unlike the reference
there is no ``d % 128`` / ``rows % 8`` routing: the kernels take any shape.
"""
from __future__ import annotations

import torch

from repro_torch.core.table import TableDesign
from repro_torch.kernels.interp.ops import lib_meta  # noqa: F401 (twin path)
from repro_torch.kernels.softmax.kernel import (softmax_lib_cuda,
                                                softmax_tab_cuda)
from repro_torch.kernels.softmax.ref import (approx_softmax_library_ref,
                                             fused_softmax_ref)
from repro_torch.numerics.registry import get_table


def _meta(design: TableDesign) -> dict:
    """The per-table meta dict of one design (the reference's ``_meta``):
    widths and the datapath row, no func id."""
    return {
        "in_bits": design.in_bits,
        "out_bits": design.out_bits,
        "eval": {
            "eval_bits": design.eval_bits,
            "k": design.k,
            "sq_trunc": design.sq_trunc,
            "lin_trunc": design.lin_trunc,
            "degree": design.degree,
        },
    }


def approx_softmax_library(x: torch.Tensor, library) -> torch.Tensor:
    """Softmax over the last axis with the exp2neg and recip tables read
    in-kernel from the library ROM; any leading shape, output in x's
    dtype."""
    if not x.is_cuda:
        return approx_softmax_library_ref(x, library)
    d = x.shape[-1]
    return softmax_lib_cuda(x.reshape(-1, d), library).reshape(x.shape)


def approx_softmax_fused(x: torch.Tensor,
                         exp_design: TableDesign | None = None,
                         recip_design: TableDesign | None = None
                         ) -> torch.Tensor:
    """Softmax over the last axis with the exp table read in-kernel from
    ``exp_design`` and 1/sum from ``recip_design`` (default: the session's
    tables through ``get_table``); any leading shape, output in x's dtype.
    A design whose coefficients exceed int32 raises, as the reference's
    ``device_coeffs(checked=True)`` does."""
    exp_design = exp_design if exp_design is not None else get_table("exp2neg")
    recip_design = (recip_design if recip_design is not None
                    else get_table("recip"))
    d = x.shape[-1]
    if x.is_cuda:
        out = softmax_tab_cuda(x.reshape(-1, d), exp_design, recip_design)
    else:
        out = fused_softmax_ref(x.reshape(-1, d),
                                exp_design.device_coeffs(x.device),
                                recip_design.device_coeffs(x.device),
                                _meta(exp_design), _meta(recip_design))
    return out.reshape(x.shape)
