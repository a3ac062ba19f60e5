"""Grouped-query attention with a KV cache (twin of
``repro/models/attention.py``, the GQA path).

``attention_core`` takes the numerics backend's fused attention hook when it
has one (the ``flash_attn_lib`` kernel on a CUDA device) and otherwise the
reference's chunked online-softmax glue, every exponential and reciprocal
through the backend. Decode writes the new K/V rows into the cache in
place.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import apply_rope, pdtype, rope_angles, spec

NEG = -1e30
M_FLOOR = -1e20  # running-max clamp: exp(NEG - M_FLOOR) == 0
# the glue path skips dead key chunks (a host read of the chunk's
# positions) once a call has this many of them
SKIP_CHUNKS = 8
_F32 = torch.float32


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., B, KV, S, D)
    v: torch.Tensor  # (..., B, KV, S, D)
    pos: torch.Tensor  # (..., B, S) int32 positions per slot, -1 = empty


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """(B, Tq, Tk) bool validity mask."""
    d = q_pos[:, :, None] - kv_pos[:, None, :]
    ok = kv_pos[:, None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    return ok


def _divisor_chunk(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def attention_core(q, k, v, q_pos, kv_pos, numerics, causal: bool = True,
                   window: Optional[int] = None, q_chunk: int = 1024,
                   kv_chunk: int = 1024,
                   softmax_scale: float | None = None) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,KV,Dk/Dv); *_pos: (B, S*) int32."""
    b, sq, h, d = q.shape
    _, sk, kvh, dk = k.shape
    dv = v.shape[-1]
    g = h // kvh
    fused = getattr(numerics, "fused_attention", None)
    if fused is not None:
        out = fused(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                    scale=softmax_scale)
        if out is not None:
            return out
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    q = q.reshape(b, sq, kvh, g, d)
    q_chunk = _divisor_chunk(sq, q_chunk)
    kv_chunk = _divisor_chunk(sk, kv_chunk)
    nq, nk = sq // q_chunk, sk // kv_chunk

    def scores(qb, kb):
        return torch.einsum("bqkgd,bskd->bkgqs", qb.to(_F32),
                            kb.to(_F32)) * scale

    if nq == 1 and nk == 1:
        s = scores(q, k)
        m = _mask(q_pos, kv_pos, causal, window)[:, None, None]
        s = torch.where(m, s, NEG)
        mx = torch.clamp(s.amax(-1, keepdim=True), min=M_FLOOR)
        p = numerics.exp_neg(s - mx)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(_F32),
                         v.to(_F32))
        o = o * numerics.recip_pos(l).permute(0, 3, 1, 2, 4)
        return o.reshape(b, sq, h, dv).to(v.dtype)

    imax = torch.iinfo(torch.int32).max
    use_skip = nk >= SKIP_CHUNKS

    def q_block(qb, qpb):
        tq = qb.shape[1]
        m_i = torch.full((b, kvh, g, tq), M_FLOOR, dtype=_F32, device=q.device)
        l_i = torch.zeros((b, kvh, g, tq), dtype=_F32, device=q.device)
        acc = torch.zeros((b, kvh, g, tq, dv), dtype=_F32, device=q.device)
        for c in range(nk):
            sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
            kb, vb, kpb = k[:, sl], v[:, sl], kv_pos[:, sl]
            masked = True
            if use_skip:  # chunk liveness, as the reference's lax.cond skip
                need = bool((kpb >= 0).any())
                if causal:
                    need &= bool(torch.where(kpb < 0, imax, kpb).min()
                                 <= qpb.max())
                if window is not None:
                    need &= bool(kpb.max() > qpb.min() - window)
                if not need:
                    continue
                full = bool((kpb >= 0).all())
                if causal:
                    full &= bool(kpb.max() <= qpb.min())
                if window is not None:
                    full &= bool(kpb.min() > qpb.max() - window)
                masked = not full
            s = scores(qb, kb)
            if masked:
                s = torch.where(_mask(qpb, kpb, causal, window)[:, None, None],
                                s, NEG)
            m_new = torch.clamp(torch.maximum(m_i, s.amax(-1)), min=M_FLOOR)
            p = numerics.exp_neg(s - m_new[..., None])
            corr = numerics.exp_neg(torch.clamp(m_i - m_new, max=0.0))
            l_i = l_i * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype).to(_F32),
                              vb.to(_F32))
            acc = acc * corr[..., None] + pv
            m_i = m_new
        o = acc * numerics.recip_pos(torch.clamp(l_i, min=1e-30))[..., None]
        return o.permute(0, 3, 1, 2, 4).reshape(b, tq, h, dv).to(v.dtype)

    outs = [q_block(q[:, i * q_chunk:(i + 1) * q_chunk],
                    q_pos[:, i * q_chunk:(i + 1) * q_chunk])
            for i in range(nq)]
    return torch.cat(outs, dim=1)


def gqa_shapes(cfg) -> dict:
    d, hd, dt = cfg.d_model, cfg.head_size, pdtype(cfg)
    return {"wq": spec((d, cfg.n_heads * hd), dt),
            "wk": spec((d, cfg.n_kv_heads * hd), dt),
            "wv": spec((d, cfg.n_kv_heads * hd), dt),
            "wo": spec((cfg.n_heads * hd, d), dt)}


def _gqa_qkv(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg):
    b, s, _ = x.shape
    hd = cfg.head_size
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_prefill(p: dict, x, positions, cfg, numerics, cache_len: int):
    """Prompt pass that also emits a right-padded KV cache."""
    b, s, _ = x.shape
    if s > cache_len:
        raise ValueError(f"prompt length {s} exceeds cache_len {cache_len}")
    q, k, v = _gqa_qkv(p, x, positions, cfg)
    o = attention_core(q, k, v, positions, positions, numerics, causal=True)
    y = o.reshape(b, s, -1) @ p["wo"]
    kc = torch.zeros((b, cfg.n_kv_heads, cache_len, cfg.head_size),
                     dtype=k.dtype, device=x.device)
    vc = torch.zeros_like(kc)
    pos_buf = torch.full((b, cache_len), -1, dtype=torch.int32,
                         device=x.device)
    kc[:, :, :s] = k.transpose(1, 2)
    vc[:, :, :s] = v.transpose(1, 2)
    pos_buf[:, :s] = positions.to(torch.int32)
    return y, KVCache(kc, vc, pos_buf)


def decode_kv_chunk(cache_len: int) -> int:
    """The key chunk ``gqa_decode`` hands ``attention_core``."""
    return min(4096, cache_len)


def decode_reads_host(cache_len: int, numerics) -> bool:
    """Whether ``gqa_decode`` on a cache of ``cache_len`` rows reads device
    values back to the host: the glue path's chunk liveness test
    (``SKIP_CHUNKS`` or more key chunks), which ``attention_core`` takes
    where ``numerics`` has no fused attention or the cache is longer than
    the fused attention takes."""
    from repro_torch.numerics.ops import FUSED_ATTN_MAX_KEYS

    if (getattr(numerics, "fused_attention", None) is not None
            and cache_len <= FUSED_ATTN_MAX_KEYS):
        return False
    return cache_len // _divisor_chunk(
        cache_len, decode_kv_chunk(cache_len)) >= SKIP_CHUNKS


def _decode_positions(pos, b: int, device):
    """Normalize a decode position: scalar (uniform batch) or (B,) per
    slot. Returns (pos, positions (B, 1))."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    positions = (pos.reshape(1, 1).expand(b, 1) if pos.dim() == 0
                 else pos.reshape(b, 1))
    return pos, positions.to(torch.int32)


def gqa_decode(p: dict, x, pos, cache: KVCache, cfg, numerics):
    """x: (B, 1, d); pos: scalar or (B,) per-slot positions; ``cache`` is
    one layer's (B, KV, S, D) view, updated in place and returned."""
    b = x.shape[0]
    pos, positions = _decode_positions(pos, b, x.device)
    q, k, v = _gqa_qkv(p, x, positions, cfg)
    s_max = cache.k.shape[2]
    # the reference's dynamic_update_slice clamps the write index
    slot = torch.clamp(positions[:, 0], 0, s_max - 1)
    rows = torch.arange(b, device=x.device)
    cache.k[rows, :, slot] = k[:, 0]
    cache.v[rows, :, slot] = v[:, 0]
    cache.pos[rows, slot] = positions[:, 0]
    o = attention_core(q, cache.k.transpose(1, 2), cache.v.transpose(1, 2),
                       positions, cache.pos, numerics, causal=True,
                       kv_chunk=decode_kv_chunk(s_max))
    y = o.reshape(b, 1, -1) @ p["wo"]
    return y, cache
