"""Fused attention (twin of ``repro/kernels/flashattn/ops.py``): per-table
(``attention_fused``, one design per table, positions ``arange``) or
library-bound (``attention_fused_library``). The CUDA kernel for CUDA
tensors, the plain unchunked version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.core.table import TableDesign
from repro_torch.kernels.flashattn.kernel import (flash_attn_lib_cuda,
                                                  flash_attn_tab_cuda)
from repro_torch.kernels.flashattn.ref import (attention_fused_library_ref,
                                               attention_fused_ref)
from repro_torch.numerics.registry import get_table


def attention_fused_library(q, k, v, library, *, causal: bool = True,
                            scale: float | None = None,
                            window: int | None = None, q_pos=None,
                            kv_pos=None) -> torch.Tensor:
    """(B, Sq, H, D) attention with the library's exp2neg and recip tables
    read in-kernel. ``q_pos`` / ``kv_pos``: (B, S*) absolute positions
    (-1 = dead KV slot / padded query row); ``None`` = ``arange``. Grouped
    K/V (B, Sk, KVH, D*) pass unexpanded."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads over {k.shape[2]} KV")
    if not q.is_cuda:
        return attention_fused_library_ref(q, k, v, library, causal=causal,
                                           scale=scale, window=window,
                                           q_pos=q_pos, kv_pos=kv_pos)
    b, sq, _, _ = q.shape
    sk = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(sq, dtype=torch.int32, device=q.device).expand(b, sq)
    if kv_pos is None:
        kv_pos = torch.arange(sk, dtype=torch.int32, device=q.device).expand(b, sk)
    return flash_attn_lib_cuda(q, k, v, q_pos, kv_pos, library, causal=causal,
                               window=window, scale=scale)


def attention_fused(q, k, v, *, causal: bool = True,
                    scale: float | None = None,
                    exp_design: TableDesign | None = None,
                    recip_design: TableDesign | None = None) -> torch.Tensor:
    """(B, S, H, D) multi-head attention with the exp table read in-kernel
    from ``exp_design`` and 1/l from ``recip_design`` (default: the
    session's tables through ``get_table``); causal by index. K/V come with
    the query's H heads: a GQA caller expands its KV heads first."""
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"expand GQA kv heads before calling: "
                         f"{q.shape[2]} query heads, {k.shape[2]} KV heads")
    exp_design = exp_design if exp_design is not None else get_table("exp2neg")
    recip_design = (recip_design if recip_design is not None
                    else get_table("recip"))
    kw = dict(causal=causal, scale=scale)
    if q.is_cuda:
        return flash_attn_tab_cuda(q, k, v, exp_design, recip_design, **kw)
    return attention_fused_ref(q, k, v, exp_design, recip_design, **kw)
