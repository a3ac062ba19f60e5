"""CUDA wrapper of ``rmsnorm_lib`` (``csrc/rmsnorm.cu``), the port of
``repro/kernels/rmsnorm/kernel.py`` ``fused_rmsnorm_lib`` /
``_rmsnorm_lib_kernel``. The reference needs rows % 8 and D % 128; the
kernel takes any row count and any D."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interp.kernel import slot_args

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_lib_cuda(x: torch.Tensor, gamma: torch.Tensor, library,
                     eps: float = 1e-6) -> torch.Tensor:
    """x: (rows, D) float32 or bfloat16 on CUDA; gamma: (D,); the rsqrt
    table read from ``library``'s ROM. Output in x's dtype."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_lib takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, D), got {tuple(x.shape)}")
    rows, d = x.shape
    dev = x.device
    x = x.contiguous()
    gamma = gamma.to(device=dev, dtype=torch.float32).contiguous()
    if gamma.shape != (d,):
        raise ValueError(f"gamma {tuple(gamma.shape)} for D={d}")
    rom = library.coeffs
    if rom.device != dev:
        raise ValueError(f"library ROM on {rom.device}, x on {dev}")
    out = torch.empty_like(x)
    lib = build.load()
    rc = lib.repro_rmsnorm_lib(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, d,
        _DTYPES[x.dtype], float(eps), rom.data_ptr(),
        library.walk_rows()[1].data_ptr(),
        build.int_array(slot_args(library, "rsqrt")), dev.index or 0,
        build.stream_of(dev))
    build.check("rmsnorm_lib", rc)
    build.LAUNCHES["rmsnorm_lib"] += 1
    return out
