"""Plain PyTorch versions of the fused RMSNorm (twins of
``repro/kernels/rmsnorm/ref.py`` ``fused_rmsnorm_ref``, the per-table
kernel's, and ``fused_rmsnorm_lib_ref``, the library-bound one's)."""
from __future__ import annotations

import torch

from repro_torch.kernels.interp.ref import lut_rom_ref, pow2


def rsqrt_codes(ms: torch.Tensor, meta: dict):
    """The rsqrt table code of ms > 0 and its exponent half h: ms = v * 4^h,
    v in [1, 4); an even IEEE exponent selects segment [1, 2), an odd one
    [2, 4)."""
    bits = ms.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    e = ((bits >> 23) & 255) - 127
    mant = bits & ((1 << 23) - 1)
    b = meta["in_bits"]
    halfcode = 1 << (b - 1)
    rnd = 1 << (23 - (b - 1) - 1)
    frac_code = torch.clamp((mant + rnd) >> (23 - (b - 1)), 0, halfcode - 1)
    even = (e & 1) == 0
    codes = torch.where(even, frac_code, halfcode + frac_code)
    h = torch.where(even, torch.div(e, 2, rounding_mode="floor"),
                    torch.div(e - 1, 2, rounding_mode="floor"))
    return codes.to(torch.int32), h


def fused_rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor,
                      coeffs: torch.Tensor, meta: dict,
                      eps: float = 1e-6) -> torch.Tensor:
    """x: (rows, D); the rsqrt read from ``coeffs``, one design's (2^R, 3)
    rows (meta from ``softmax.ops._meta``) or the padded (F, R_max, 3)
    library ROM at the static func id of ``lib_meta``; then the reference's
    glue."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True) + eps
    codes, h = rsqrt_codes(ms, meta)
    tab = lut_rom_ref(codes, coeffs, meta).to(torch.float32)
    rs = tab * (2.0 ** -meta["out_bits"]) * pow2(-h)
    return (xf * rs * gamma.to(torch.float32)).to(x.dtype)


fused_rmsnorm_lib_ref = fused_rmsnorm_ref  # the ROM operand, read by fid


def approx_rmsnorm_library_ref(x: torch.Tensor, gamma: torch.Tensor,
                               library, eps: float = 1e-6) -> torch.Tensor:
    """The plain version at the wrapper's signature: any leading shape."""
    from repro_torch.kernels.interp.ops import lib_meta

    d = x.shape[-1]
    out = fused_rmsnorm_lib_ref(x.reshape(-1, d), gamma, library.coeffs,
                                lib_meta(library, "rsqrt"), eps)
    return out.reshape(x.shape)
