"""Library-bound fused softmax (twin of ``repro/kernels/softmax/ops.py``
``approx_softmax_library``): the CUDA kernel for CUDA tensors, always; the
plain version for CPU tensors. Unlike the reference there is no
``d % 128`` / ``rows % 8`` routing: the kernel takes any shape."""
from __future__ import annotations

import torch

from repro_torch.kernels.interp.ops import lib_meta  # noqa: F401 (twin path)
from repro_torch.kernels.softmax.kernel import softmax_lib_cuda
from repro_torch.kernels.softmax.ref import approx_softmax_library_ref


def approx_softmax_library(x: torch.Tensor, library) -> torch.Tensor:
    """Softmax over the last axis with the exp2neg and recip tables read
    in-kernel from the library ROM; any leading shape, output in x's
    dtype."""
    if not x.is_cuda:
        return approx_softmax_library_ref(x, library)
    d = x.shape[-1]
    return softmax_lib_cuda(x.reshape(-1, d), library).reshape(x.shape)
