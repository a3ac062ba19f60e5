"""CUDA wrapper of ``softmax_lib`` (``csrc/softmax.cu``), the port of
``repro/kernels/softmax/kernel.py`` ``fused_softmax_lib`` /
``_softmax_lib_kernel``. The reference needs rows % 8 and D % 128; the
kernel takes any row count and any D (one warp per row up to D = 1024, one
block per row beyond)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interp.kernel import slot_args

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def softmax_lib_cuda(x: torch.Tensor, library, return_e: bool = False):
    """x: (rows, D) float32 or bfloat16 on CUDA; the exp2neg and recip
    tables read from ``library``'s ROM. Returns the softmax over the last
    axis in x's dtype, and with ``return_e`` also the float32 exp terms e
    (before the reciprocal scale) for bit-exact checks."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"softmax_lib takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, D), got {tuple(x.shape)}")
    rows, d = x.shape
    dev = x.device
    x = x.contiguous()
    rom = library.coeffs
    if rom.device != dev:
        raise ValueError(f"library ROM on {rom.device}, x on {dev}")
    out = torch.empty_like(x)
    e = (torch.empty((rows, d), dtype=torch.float32, device=dev)
         if return_e else None)
    lib = build.load()
    rc = lib.repro_softmax_lib(
        x.data_ptr(), out.data_ptr(), None if e is None else e.data_ptr(),
        rows, d, _DTYPES[x.dtype], rom.data_ptr(),
        library.walk_rows()[1].data_ptr(),
        build.int_array(slot_args(library, "exp2neg")),
        build.int_array(slot_args(library, "recip")), dev.index or 0,
        build.stream_of(dev))
    build.check("softmax_lib", rc)
    build.LAUNCHES["softmax_lib"] += 1
    return (out, e) if return_e else out
