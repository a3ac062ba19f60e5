"""CUDA wrappers of ``rmsnorm_lib`` and ``rmsnorm_tab`` (``csrc/rmsnorm.cu``),
the ports of ``repro/kernels/rmsnorm/kernel.py`` ``fused_rmsnorm_lib`` /
``_rmsnorm_lib_kernel`` and ``fused_rmsnorm`` / ``_rmsnorm_kernel``. The
reference needs rows % 8 and D % 128; the kernels take any row count and
any D."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interp.kernel import design_args, slot_args

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _operands(name: str, x: torch.Tensor, gamma: torch.Tensor):
    """x made contiguous, gamma as float32 on x's device, and the output."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, D), got {tuple(x.shape)}")
    x = x.contiguous()
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    if gamma.shape != (x.shape[1],):
        raise ValueError(f"gamma {tuple(gamma.shape)} for D={x.shape[1]}")
    return x, gamma, torch.empty_like(x)


def rmsnorm_lib_cuda(x: torch.Tensor, gamma: torch.Tensor, library,
                     eps: float = 1e-6) -> torch.Tensor:
    """x: (rows, D) float32 or bfloat16 on CUDA; gamma: (D,); the rsqrt
    table read from ``library``'s ROM. Output in x's dtype."""
    x, gamma, out = _operands("rmsnorm_lib", x, gamma)
    dev = x.device
    rom = library.coeffs
    if rom.device != dev:
        raise ValueError(f"library ROM on {rom.device}, x on {dev}")
    rc = build.load().repro_rmsnorm_lib(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], _DTYPES[x.dtype], float(eps), rom.data_ptr(),
        library.walk_rows()[1].data_ptr(),
        build.int_array(slot_args(library, "rsqrt")), dev.index or 0,
        build.stream_of(dev))
    build.check("rmsnorm_lib", rc)
    build.LAUNCHES["rmsnorm_lib"] += 1
    return out


def rmsnorm_tab_cuda(x: torch.Tensor, gamma: torch.Tensor, design,
                     eps: float = 1e-6) -> torch.Tensor:
    """The per-table RMSNorm: x (rows, D) float32 or bfloat16 on CUDA,
    gamma (D,); the rsqrt table read from ``design``'s own (2^R, 3)
    coefficients (``device_coeffs``, which raises for a design that exceeds
    int32), its odd/even-exponent split at the design's own in_bits.
    Output in x's dtype."""
    x, gamma, out = _operands("rmsnorm_tab", x, gamma)
    dev = x.device
    coeffs = design.device_coeffs(dev)
    rc = build.load().repro_rmsnorm_tab(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], _DTYPES[x.dtype], float(eps), coeffs.data_ptr(),
        build.int_array(design_args(design)), dev.index or 0,
        build.stream_of(dev))
    build.check("rmsnorm_tab", rc)
    build.LAUNCHES["rmsnorm_tab"] += 1
    return out
