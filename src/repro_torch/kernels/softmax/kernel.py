"""CUDA wrappers of ``softmax_lib`` and ``softmax_tab`` (``csrc/softmax.cu``),
the ports of ``repro/kernels/softmax/kernel.py`` ``fused_softmax_lib`` /
``_softmax_lib_kernel`` and ``fused_softmax`` / ``_softmax_kernel``. The
reference needs rows % 8 and D % 128; the kernels take any row count and any
D (one warp per row up to D = 1024, one block per row beyond)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interp.kernel import design_args, slot_args

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _operands(name: str, x: torch.Tensor, return_e: bool):
    """x made contiguous, its output and, with ``return_e``, the float32 e
    buffer."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, D), got {tuple(x.shape)}")
    x = x.contiguous()
    e = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
         if return_e else None)
    return x, torch.empty_like(x), e


def softmax_lib_cuda(x: torch.Tensor, library, return_e: bool = False):
    """x: (rows, D) float32 or bfloat16 on CUDA; the exp2neg and recip
    tables read from ``library``'s ROM. Returns the softmax over the last
    axis in x's dtype, and with ``return_e`` also the float32 exp terms e
    (before the reciprocal scale) for bit-exact checks."""
    x, out, e = _operands("softmax_lib", x, return_e)
    dev = x.device
    rom = library.coeffs
    if rom.device != dev:
        raise ValueError(f"library ROM on {rom.device}, x on {dev}")
    rc = build.load().repro_softmax_lib(
        x.data_ptr(), out.data_ptr(), None if e is None else e.data_ptr(),
        x.shape[0], x.shape[1], _DTYPES[x.dtype], rom.data_ptr(),
        library.walk_rows()[1].data_ptr(),
        build.int_array(slot_args(library, "exp2neg")),
        build.int_array(slot_args(library, "recip")), dev.index or 0,
        build.stream_of(dev))
    build.check("softmax_lib", rc)
    build.LAUNCHES["softmax_lib"] += 1
    return (out, e) if return_e else out


def softmax_tab_cuda(x: torch.Tensor, exp_design, recip_design,
                     return_e: bool = False):
    """The per-table softmax: x (rows, D) float32 or bfloat16 on CUDA; the
    exp table read from ``exp_design``'s own (2^R, 3) coefficients, the
    reciprocal from ``recip_design``'s (``device_coeffs``, which raises for
    a design that exceeds int32). The two designs may differ in R and in
    their widths. Returns as :func:`softmax_lib_cuda`; raises if the two
    tables do not fit one block's shared memory."""
    x, out, e = _operands("softmax_tab", x, return_e)
    dev = x.device
    ec = exp_design.device_coeffs(dev)
    rc = recip_design.device_coeffs(dev)
    ret = build.load().repro_softmax_tab(
        x.data_ptr(), out.data_ptr(), None if e is None else e.data_ptr(),
        x.shape[0], x.shape[1], _DTYPES[x.dtype], ec.data_ptr(),
        build.int_array(design_args(exp_design)), rc.data_ptr(),
        build.int_array(design_args(recip_design)), dev.index or 0,
        build.stream_of(dev))
    build.check("softmax_tab", ret)
    build.LAUNCHES["softmax_tab"] += 1
    return (out, e) if return_e else out
