"""Plain PyTorch version of the library-bound flash attention (twin of
``repro/kernels/flashattn/ref.py`` ``flash_attention_lib_ref`` and of the
reference wrapper's ``use_kernel=False`` path).

``flash_attention_lib_ref`` is unchunked: the scores of a whole (query,
key) block are formed at once, so the online-softmax correction never runs.
A chunked kernel differs from it by table ulps (each correction is itself a
table read), not by float eps; ``repro_torch.numerics.ops.softmax_ulp_bound``
states the scale. ``flash_attention_lib_chunked_ref`` is the twin of the
reference kernel's ``_flash_loop`` itself, tile by tile: against a kernel
with the same key tiles it differs only where float reassociation flips a
table code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.interp.ref import LOG2E, table_exp_neg, table_recip

NEG = -1e30
M_FLOOR = -1e20


def flash_attention_lib_ref(q, k, v, q_pos, kv_pos, coeffs, exp_meta: dict,
                            recip_meta: dict, *, causal: bool = True,
                            window: int | None = None,
                            scale: float | None = None) -> torch.Tensor:
    """q: (N, Sq, D); k: (N, Sk, Dk); v: (N, Sk, Dv); q_pos: (N, Sq),
    kv_pos: (N, Sk) int32 absolute positions (-1 = dead / padded)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("nqd,nkd->nqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = torch.where(_mask(q_pos, kv_pos, causal, window), s,
                    torch.full_like(s, NEG))
    m = torch.clamp(s.amax(-1, keepdim=True), min=M_FLOOR)
    p = table_exp_neg((m - s) * LOG2E, coeffs, exp_meta)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("nqk,nkd->nqd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    recip = table_recip(torch.clamp(l, min=1e-30), coeffs, recip_meta)
    return (o * recip).to(v.dtype)


def _mask(q_pos, kv_pos, causal, window):
    ok = (kv_pos >= 0)[:, None, :]
    if causal:
        ok = ok & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if window is not None:
        ok = ok & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return ok


def flash_attention_lib_chunked_ref(q, k, v, q_pos, kv_pos, coeffs,
                                    exp_meta: dict, recip_meta: dict, *,
                                    causal: bool = True,
                                    window: int | None = None,
                                    scale: float | None = None,
                                    block_k: int = 64) -> torch.Tensor:
    """Twin of the reference's ``_flash_loop`` over ``block_k``-key tiles
    (same operands as :func:`flash_attention_lib_ref`): q scaled before the
    product, the running max floored at M_FLOOR, p and the correction from
    the exp2neg table, p cast to V's dtype for P.V, 1/max(l, 1e-30) from the
    recip table. Keys past Sk do not exist (no padded tail)."""
    n, sq, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    qf = q.to(torch.float32) * scale
    m = torch.full((n, sq, 1), M_FLOOR, dtype=torch.float32, device=q.device)
    l = torch.zeros((n, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        sl = slice(k0, k0 + block_k)
        s = torch.einsum("nqd,nkd->nqk", qf, k[:, sl].to(torch.float32))
        s = torch.where(_mask(q_pos, kv_pos[:, sl], causal, window), s,
                        torch.full_like(s, NEG))
        m_new = torch.clamp(torch.maximum(m, s.amax(-1, keepdim=True)),
                            min=M_FLOOR)
        p = table_exp_neg((m_new - s) * LOG2E, coeffs, exp_meta)
        corr = table_exp_neg((m_new - m) * LOG2E, coeffs, exp_meta)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.einsum("nqk,nkd->nqd", p.to(v.dtype).to(torch.float32),
                          v[:, sl].to(torch.float32))
        acc = acc * corr + pv
        m = m_new
    recip = table_recip(torch.clamp(l, min=1e-30), coeffs, recip_meta)
    return (acc * recip).to(v.dtype)


def attention_fused_library_ref(q, k, v, library, *, causal: bool = True,
                                scale: float | None = None,
                                window: int | None = None, q_pos=None,
                                kv_pos=None,
                                block_k: int | None = None) -> torch.Tensor:
    """The plain version at the wrapper's signature: q (B, Sq, H, D), k / v
    (B, Sk, KVH, D*), positions (B, S*); grouped KV heads are expanded to
    one stripe per query head (query head h reads KV head h // g).
    ``block_k`` selects the tile-by-tile twin instead of the unchunked
    oracle."""
    from repro_torch.kernels.interp.ops import lib_meta

    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(sq, dtype=torch.int32, device=dev).expand(b, sq)
    if kv_pos is None:
        kv_pos = torch.arange(sk, dtype=torch.int32, device=dev).expand(b, sk)
    qn = q.transpose(1, 2).reshape(b * h, sq, d)
    kn = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, sk, -1)
    vn = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, sk, dv)
    qp = q_pos.to(torch.int32).repeat_interleave(h, dim=0)
    kp = kv_pos.to(torch.int32).repeat_interleave(h, dim=0)
    args = (qn, kn, vn, qp, kp, library.coeffs, lib_meta(library, "exp2neg"),
            lib_meta(library, "recip"))
    kw = dict(causal=causal, window=window, scale=scale)
    o = (flash_attention_lib_ref(*args, **kw) if block_k is None else
         flash_attention_lib_chunked_ref(*args, block_k=block_k, **kw))
    return o.reshape(b, h, sq, dv).transpose(1, 2)
