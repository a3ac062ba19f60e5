"""Library-bound fused RMSNorm (twin of ``repro/kernels/rmsnorm/ops.py``
``approx_rmsnorm_library``): the CUDA kernel for CUDA tensors, the plain
version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_lib_cuda
from repro_torch.kernels.rmsnorm.ref import approx_rmsnorm_library_ref


def approx_rmsnorm_library(x: torch.Tensor, gamma: torch.Tensor, library,
                           eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with the rsqrt table read in-kernel from
    the library ROM; any leading shape."""
    if not x.is_cuda:
        return approx_rmsnorm_library_ref(x, gamma, library, eps)
    d = x.shape[-1]
    return rmsnorm_lib_cuda(x.reshape(-1, d), gamma, library,
                            eps).reshape(x.shape)
