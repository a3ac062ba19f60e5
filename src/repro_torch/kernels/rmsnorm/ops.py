"""Fused RMSNorm over the last axis (twin of ``repro/kernels/rmsnorm/ops.py``):
per-table (``approx_rmsnorm_fused``, one rsqrt design) or library-bound
(``approx_rmsnorm_library``). The CUDA kernel for CUDA tensors, the plain
version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.core.table import TableDesign
from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_lib_cuda,
                                                rmsnorm_tab_cuda)
from repro_torch.kernels.rmsnorm.ref import (approx_rmsnorm_library_ref,
                                             fused_rmsnorm_ref)
from repro_torch.kernels.softmax.ops import _meta
from repro_torch.numerics.registry import get_table


def approx_rmsnorm_library(x: torch.Tensor, gamma: torch.Tensor, library,
                           eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with the rsqrt table read in-kernel from
    the library ROM; any leading shape; one op where a profiler traces a
    fake x (``build.tracer_for``)."""
    tracer = build.tracer_for(x)
    if tracer is not None:
        return tracer.kernel(
            "rmsnorm_lib",
            lambda: approx_rmsnorm_library_ref(x, gamma, library, eps),
            (x, gamma))
    if not x.is_cuda:
        return approx_rmsnorm_library_ref(x, gamma, library, eps)
    d = x.shape[-1]
    return rmsnorm_lib_cuda(x.reshape(-1, d), gamma, library,
                            eps).reshape(x.shape)


def approx_rmsnorm_fused(x: torch.Tensor, gamma: torch.Tensor,
                         design: TableDesign | None = None,
                         eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with the rsqrt table read in-kernel from
    ``design`` (default: the session's table through ``get_table``); any
    leading shape, output in x's dtype. A design whose coefficients exceed
    int32 raises, as the reference's ``device_coeffs(checked=True)``
    does."""
    design = design if design is not None else get_table("rsqrt")
    d = x.shape[-1]
    if x.is_cuda:
        out = rmsnorm_tab_cuda(x.reshape(-1, d), gamma, design, eps)
    else:
        out = fused_rmsnorm_ref(x.reshape(-1, d), gamma,
                                design.device_coeffs(x.device),
                                _meta(design), eps)
    return out.reshape(x.shape)
