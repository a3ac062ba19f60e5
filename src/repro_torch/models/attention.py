"""Attention with a KV cache (twin of ``repro/models/attention.py``): GQA
with QKV bias and sliding windows, and MLA (multi-head latent attention).

``attention_core`` takes the numerics backend's fused attention hook when it
has one (the ``flash_attn_lib`` kernel on a CUDA device) and otherwise the
reference's chunked online-softmax glue, every exponential and reciprocal
through the backend. Decode writes the new K/V rows into the cache in
place. A windowed GQA cache is a ring of ``min(cache_len, window)`` rows:
row r holds the position p with p % rows == r. An MLA cache holds the
compressed latent (``k``) and the shared rope key (``v``); decode expands
the whole cache through ``wkv_b`` every step, as the reference does.
``gqa_train`` is the forward the encoder runs (non-causal over the frames);
cross attention (``cross_kv`` / ``cross_apply``) attends from the decoder
to the encoder's output with every query and key position 0, so every key
is live. Under ``cfg.learned_pos`` no RoPE is applied.

``gqa_train`` / ``mla_train`` are the train path's forwards (no cache),
differentiated by autograd: the running max of the glue path is detached
where the reference stops its gradient, and nothing autograd saves is
written in place. A fused attention hook has no backward: the train step
refuses a fused backend for CUDA parameters before any launch.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models.layers import (apply_rope, pdtype, rope_angles, spec,
                                       tp_cols)

NEG = -1e30
M_FLOOR = -1e20  # running-max clamp: exp(NEG - M_FLOOR) == 0
# the glue path skips dead key chunks (a host read of the chunk's
# positions) once a call has this many of them
SKIP_CHUNKS = 8
_F32 = torch.float32


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., B, KV, S, D)  [MLA: (..., B, S, kv_lora)]
    v: torch.Tensor  # (..., B, KV, S, D)  [MLA: (..., B, S, rope_dim)]
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


def n_chunks(n: int, chunk: int) -> int:
    """The chunks ``attention_core``'s glue path cuts an axis of ``n`` into:
    ``min(chunk, n)`` wide, the last one shorter where ``chunk`` does not
    divide ``n``."""
    return -(-n // min(chunk, n))


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
    # the reference cuts at the largest divisor (its scan needs equal
    # chunks); this loop takes a shorter last chunk, so a prime length
    # is not cut into one-key chunks
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    nq, nk = n_chunks(sq, q_chunk), n_chunks(sk, kv_chunk)

    def scores(qb, kb):
        return torch.einsum("bqkgd,bskd->bkgqs", qb.to(_F32),
                            kb.to(_F32)) * scale

    if nq == 1 and nk == 1:
        s = scores(q, k)
        m = _mask(q_pos, kv_pos, causal, window)[:, None, None]
        s = torch.where(m, s, NEG)
        # the reference's stop_gradient: the max only shifts the exponent
        mx = torch.clamp(s.amax(-1, keepdim=True).detach(), min=M_FLOOR)
        p = numerics.exp_neg(s - mx)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(_F32),
                         v.to(_F32))
        o = o * numerics.recip_pos(l).permute(0, 3, 1, 2, 4)
        return o.reshape(b, sq, h, dv).to(v.dtype)

    imax = torch.iinfo(torch.int32).max
    # a traced step (``launch.xprof``: fake tensors, no values) has no
    # positions to read: every chunk counts, masked
    use_skip = nk >= SKIP_CHUNKS and not is_fake(k)

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
            m_new = torch.clamp(torch.maximum(m_i, s.amax(-1).detach()),
                                min=M_FLOOR)
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
    out = {"wq": spec((d, cfg.n_heads * hd), dt),
           "wk": spec((d, cfg.n_kv_heads * hd), dt),
           "wv": spec((d, cfg.n_kv_heads * hd), dt),
           "wo": spec((cfg.n_heads * hd, d), dt)}
    if cfg.attn_bias:
        out.update({"bq": spec((cfg.n_heads * hd,), dt),
                    "bk": spec((cfg.n_kv_heads * hd,), dt),
                    "bv": spec((cfg.n_kv_heads * hd,), dt)})
    return out


def _replicated_kv(wk: torch.Tensor, cfg, mesh) -> bool:
    """Whether this rank holds every KV head while its query heads are a
    ``tp`` shard: the placement where ``tp`` does not divide
    ``n_kv_heads`` (``launch.sharding.placement_specs``)."""
    return (mesh is not None and mesh.tp > 1
            and wk.shape[-1] == cfg.n_kv_heads * cfg.head_size)


def _local_kv(t: torch.Tensor, hq: int, cfg, mesh, axis: int):
    """The KV heads along ``axis`` of ``t`` (every KV head) that this rank's
    ``hq`` query heads read: a narrow view where each of them serves the
    same number of local query heads, else one KV head per query head."""
    g = cfg.n_heads // cfg.n_kv_heads
    ids = [(mesh.tp_rank * hq + j) // g for j in range(hq)]
    lo, n = ids[0], ids[-1] + 1 - ids[0]
    t = t.narrow(axis, lo, n)
    if hq % n == 0 and all(ids.count(lo + i) == hq // n for i in range(n)):
        return t
    return t.index_select(axis, torch.tensor([i - lo for i in ids],
                                             device=t.device))


def _project_out(p: dict, o: torch.Tensor, mesh) -> torch.Tensor:
    """(B, S, heads, Dv) -> (B, S, d) through ``wo``: row-parallel on a
    mesh, summed over ``tp``."""
    y = o.reshape(*o.shape[:2], -1) @ p["wo"]
    return y if mesh is None else mesh.tp_sum(y)


def _gqa_qkv(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
             mesh=None):
    """q, k, v (B, S, heads, D) with RoPE: every head without a mesh; on a
    mesh this rank's query heads and its KV heads (every KV head under
    :func:`_replicated_kv`, their gradient then summed over ``tp``)."""
    b, s, _ = x.shape
    hd = cfg.head_size
    rep = _replicated_kv(p["wk"], cfg, mesh)
    xq = x if mesh is None else mesh.tp_enter(x)
    xk = x if rep else xq
    q = xq @ p["wq"]
    k = xk @ p["wk"]
    v = xk @ p["wv"]
    if cfg.attn_bias:
        q = q + tp_cols(p["bq"], q.shape[-1], mesh)
        k = k + tp_cols(p["bk"], k.shape[-1], mesh)
        v = v + tp_cols(p["bv"], v.shape[-1], mesh)
    if rep:
        k, v = mesh.tp_enter(k), mesh.tp_enter(v)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.learned_pos:  # positions were added to the embeddings
        return q, k, v
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attend_kv(q, k, v, cfg, mesh):
    """k, v (B, S, KV, D) as this rank's query heads read them
    (:func:`_local_kv` under the replicated-KV placement, else as they
    are)."""
    if not (mesh is not None and mesh.tp > 1
            and k.shape[2] == cfg.n_kv_heads):
        return k, v
    hq = q.shape[2]
    return _local_kv(k, hq, cfg, mesh, 2), _local_kv(v, hq, cfg, mesh, 2)


def gqa_train(p: dict, x, positions, cfg, numerics,
              causal: bool = True, mesh=None) -> torch.Tensor:
    """The reference's training-shaped forward with no cache: attention of
    the sequence over itself (the encoder passes ``causal=False``)."""
    q, k, v = _gqa_qkv(p, x, positions, cfg, mesh)
    k, v = _attend_kv(q, k, v, cfg, mesh)
    o = attention_core(q, k, v, positions, positions, numerics,
                       causal=causal, window=cfg.sliding_window)
    return _project_out(p, o, mesh)


def cache_rows(cfg, cache_len: int) -> int:
    """Rows of one sequence's cache: a windowed GQA cache keeps
    ``min(cache_len, window)`` (the reference's ``s_eff``)."""
    w = cfg.sliding_window
    return cache_len if w is None else min(cache_len, w)


def gqa_prefill(p: dict, x, positions, cfg, numerics, cache_len: int,
                mesh=None):
    """Prompt pass that also emits a right-padded KV cache. A windowed cache
    keeps the prompt's last ``s_eff`` rows, rotated so that row r holds the
    position p with p % s_eff == r (the slot decode writes p to); a prompt
    longer than an unwindowed cache is refused."""
    b, s, _ = x.shape
    s_eff = cache_rows(cfg, cache_len)
    if s > s_eff and cfg.sliding_window is None:
        raise ValueError(f"prompt length {s} exceeds cache_len {cache_len}")
    q, k, v = _gqa_qkv(p, x, positions, cfg, mesh)
    o = attention_core(q, *_attend_kv(q, k, v, cfg, mesh), positions,
                       positions, numerics, causal=True,
                       window=cfg.sliding_window)
    y = _project_out(p, o, mesh)
    kc = torch.zeros((b, k.shape[2], s_eff, cfg.head_size),
                     dtype=k.dtype, device=x.device)
    vc = torch.zeros_like(kc)
    pos_buf = torch.full((b, s_eff), -1, dtype=torch.int32, device=x.device)
    if s > s_eff:  # windowed: the last s_eff rows, rolled into their slots
        k, v, positions = k[:, -s_eff:], v[:, -s_eff:], positions[:, -s_eff:]
    n = k.shape[1]
    kc[:, :, :n] = k.transpose(1, 2)
    vc[:, :, :n] = v.transpose(1, 2)
    pos_buf[:, :n] = positions.to(torch.int32)
    if s > s_eff and s % s_eff:
        shift = s % s_eff
        kc, vc = torch.roll(kc, shift, 2), torch.roll(vc, shift, 2)
        pos_buf = torch.roll(pos_buf, shift, 1)
    return y, KVCache(kc, vc, pos_buf)


def gqa_cache_specs(cfg, b: int, s: int, dtype) -> KVCache:
    s_eff = cache_rows(cfg, s)
    return KVCache(k=spec((b, cfg.n_kv_heads, s_eff, cfg.head_size), dtype),
                   v=spec((b, cfg.n_kv_heads, s_eff, cfg.head_size), dtype),
                   pos=spec((b, s_eff), torch.int32))


def decode_kv_chunk(cache_len: int) -> int:
    """The key chunk ``gqa_decode`` hands ``attention_core``."""
    return min(4096, cache_len)


def _softmax_backends(numerics) -> list:
    """The backends whose fused attention decides each layer's attention
    path: every layer's softmax site under a plan (``for_layer``), else the
    backend itself."""
    if hasattr(numerics, "for_layer"):
        return [getattr(n, "softmax_backend", n)
                for n in (numerics.for_layer(i)
                          for i in range(numerics.n_layers))]
    return [numerics]


def attention_reads_host(keys: int, kv_chunk: int, numerics) -> bool:
    """Whether ``attention_core`` over ``keys`` keys in chunks of
    ``kv_chunk`` on a CUDA device reads device values back to the host in
    some layer: the glue path's chunk liveness test (``SKIP_CHUNKS`` or
    more key chunks), which it takes where a layer's softmax backend has no
    fused attention or the key axis is longer than the fused attention
    takes."""
    from repro_torch.numerics.ops import FUSED_ATTN_MAX_KEYS

    if keys <= FUSED_ATTN_MAX_KEYS and all(
            getattr(b, "fused_attention", None) is not None
            for b in _softmax_backends(numerics)):
        return False
    return n_chunks(keys, kv_chunk) >= SKIP_CHUNKS


def decode_reads_host(rows: int, numerics) -> bool:
    """Whether ``gqa_decode`` / ``mla_decode`` on a cache of ``rows`` rows
    (a windowed cache's :func:`cache_rows`) reads device values back to
    the host in some layer (:func:`attention_reads_host` with the decode's
    key chunk)."""
    return attention_reads_host(rows, decode_kv_chunk(rows), numerics)


def prefill_reads_host(seq: int, numerics) -> bool:
    """The same for ``gqa_prefill`` over a ``seq``-token prompt (the
    default 1024-key chunk)."""
    return attention_reads_host(seq, 1024, numerics)


def _decode_positions(pos, b: int, device):
    """Normalize a decode position: scalar (uniform batch) or (B,) per
    slot. Returns (pos, positions (B, 1))."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    positions = (pos.reshape(1, 1).expand(b, 1) if pos.dim() == 0
                 else pos.reshape(b, 1))
    return pos, positions.to(torch.int32)


def _write_slot(cfg, positions, s_max: int):
    """The cache row each batch row's new K/V goes to: ``pos % rows`` in a
    windowed ring, else ``pos`` clamped as the reference's
    ``dynamic_update_slice`` clamps its start index. Computed on the
    device, so a captured tick replays it for any position."""
    if cfg.sliding_window is not None:
        return torch.remainder(positions[:, 0], s_max)
    return torch.clamp(positions[:, 0], 0, s_max - 1)


def gqa_decode(p: dict, x, pos, cache: KVCache, cfg, numerics, mesh=None):
    """x: (B, 1, d); pos: scalar or (B,) per-slot positions; ``cache`` is
    one layer's (B, KV, S, D) view (on a mesh this rank's KV heads),
    updated in place and returned."""
    b = x.shape[0]
    pos, positions = _decode_positions(pos, b, x.device)
    q, k, v = _gqa_qkv(p, x, positions, cfg, mesh)
    s_max = cache.k.shape[2]
    slot = _write_slot(cfg, positions, s_max)
    rows = torch.arange(b, device=x.device)
    cache.k[rows, :, slot] = k[:, 0]
    cache.v[rows, :, slot] = v[:, 0]
    cache.pos[rows, slot] = positions[:, 0]
    kk, vv = _attend_kv(q, cache.k.transpose(1, 2), cache.v.transpose(1, 2),
                        cfg, mesh)
    o = attention_core(q, kk, vv, positions, cache.pos, numerics,
                       causal=True, window=cfg.sliding_window,
                       kv_chunk=decode_kv_chunk(s_max))
    return _project_out(p, o, mesh), cache


def mla_shapes(cfg) -> dict:
    m, d, dt = cfg.mla, cfg.d_model, pdtype(cfg)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": spec((d, m.q_lora_rank), dt),
        "q_norm": {"scale": spec((m.q_lora_rank,), dt)},
        "wq_b": spec((m.q_lora_rank, cfg.n_heads * qk), dt),
        "wkv_a": spec((d, m.kv_lora_rank + m.qk_rope_head_dim), dt),
        "kv_norm": {"scale": spec((m.kv_lora_rank,), dt)},
        "wkv_b": spec((m.kv_lora_rank,
                       cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)),
                      dt),
        "wo": spec((cfg.n_heads * m.v_head_dim, d), dt),
    }


def _col_whole(x, w, n: int, mesh):
    """``x @ w`` whole (``n`` columns) on every rank: the product itself
    where ``w`` holds every column, else this rank's columns all-gathered
    over ``tp`` (``x``'s gradient then summed over ``tp``)."""
    if mesh is None or w.shape[-1] == n:
        return x @ w
    return mesh.tp_cat(mesh.tp_enter(x) @ w, dim=-1)


def _mla_q(p, x, positions, cfg, numerics, mesh=None):
    """Queries (B, S, heads, nope + rope): the low-rank path through
    ``q_norm`` (the layer's rmsnorm, its scale as stored, as
    ``layers.apply_norm``), RoPE on the rope part. On a mesh the latent is
    whole on every rank (:func:`_col_whole`) and ``wq_b`` gives this
    rank's heads."""
    m = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    ql = numerics.rmsnorm(_col_whole(x, p["wq_a"], m.q_lora_rank, mesh),
                          p["q_norm"]["scale"]).to(x.dtype)
    if mesh is not None:
        ql = mesh.tp_enter(ql)
    q = (ql @ p["wq_b"]).reshape(b, s, -1, qk)
    qn, qr = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return torch.cat([qn, apply_rope(qr, cos, sin)], -1)


def _mla_kv_latent(p, x, positions, cfg, numerics, mesh=None):
    """The cached latents: (B, S, kv_lora) through ``kv_norm`` and the
    shared rope key (B, S, rope); whole on every rank of a mesh."""
    m = cfg.mla
    kv = _col_whole(x, p["wkv_a"], m.kv_lora_rank + m.qk_rope_head_dim,
                    mesh)
    ckv, kr = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    ckv = numerics.rmsnorm(ckv, p["kv_norm"]["scale"]).to(x.dtype)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    kr = apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0, :]
    return ckv, kr


def _mla_expand(p, ckv, kr, cfg, mesh=None):
    """Latents -> per-head K (nope + rope) and V, V a view of the
    expansion (on a mesh this rank's heads of ``wkv_b``)."""
    m = cfg.mla
    b, s, _ = ckv.shape
    if mesh is not None:
        ckv, kr = mesh.tp_enter(ckv), mesh.tp_enter(kr)
    kvb = (ckv @ p["wkv_b"]).reshape(b, s, -1,
                                     m.qk_nope_head_dim + m.v_head_dim)
    h = kvb.shape[2]
    kn, v = kvb[..., :m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim:]
    kr_b = kr[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)
    return torch.cat([kn, kr_b], -1), v


def _mla_forward(p: dict, x, positions, cfg, numerics, causal: bool,
                 mesh=None):
    """Queries, latents expanded, attention over the sequence: (y, the
    latents (B, S, kv_lora), the rope keys (B, S, rope)). ``mesh``: a
    ``tp > 1`` mesh whose heads ``wq_b`` / ``wkv_b`` / ``wo`` hold (``wo``
    row-parallel, summed over ``tp``); the latents are whole on every
    rank, as the replicated latent cache."""
    q = _mla_q(p, x, positions, cfg, numerics, mesh)
    ckv, kr = _mla_kv_latent(p, x, positions, cfg, numerics, mesh)
    k, v = _mla_expand(p, ckv, kr, cfg, mesh)
    o = attention_core(q, k, v, positions, positions, numerics,
                       causal=causal)
    return _project_out(p, o, mesh), ckv, kr


def mla_train(p: dict, x, positions, cfg, numerics,
              causal: bool = True, mesh=None) -> torch.Tensor:
    """The training-shaped MLA forward with no cache."""
    return _mla_forward(p, x, positions, cfg, numerics, causal, mesh)[0]


def mla_prefill(p: dict, x, positions, cfg, numerics, cache_len: int,
                mesh=None):
    """:func:`mla_train`'s forward (latents expanded, causal attention over
    the prompt), and the latent cache right-padded to ``cache_len`` rows.
    The reference computes the latents twice (once inside ``mla_train``);
    the same function once here."""
    m = cfg.mla
    b, s, _ = x.shape
    if s > cache_len:
        raise ValueError(f"prompt length {s} exceeds cache_len {cache_len}")
    y, ckv, kr = _mla_forward(p, x, positions, cfg, numerics, causal=True,
                              mesh=mesh)
    ck = torch.zeros((b, cache_len, m.kv_lora_rank), dtype=ckv.dtype,
                     device=x.device)
    krb = torch.zeros((b, cache_len, m.qk_rope_head_dim), dtype=kr.dtype,
                      device=x.device)
    pos_buf = torch.full((b, cache_len), -1, dtype=torch.int32,
                         device=x.device)
    ck[:, :s] = ckv
    krb[:, :s] = kr
    pos_buf[:, :s] = positions.to(torch.int32)
    return y, KVCache(ck, krb, pos_buf)


def mla_decode(p: dict, x, pos, cache: KVCache, cfg, numerics, mesh=None):
    """x: (B, 1, d); pos: scalar or (B,) per-slot positions; ``cache`` is
    one layer's latent view (k (B, S, kv_lora), v (B, S, rope), pos (B,
    S)), updated in place and returned (whole on every rank of a
    mesh)."""
    b = x.shape[0]
    pos, positions = _decode_positions(pos, b, x.device)
    q = _mla_q(p, x, positions, cfg, numerics, mesh)
    ckv, kr = _mla_kv_latent(p, x, positions, cfg, numerics, mesh)
    s_max = cache.k.shape[1]
    slot = _write_slot(cfg, positions, s_max)
    rows = torch.arange(b, device=x.device)
    cache.k[rows, slot] = ckv[:, 0]
    cache.v[rows, slot] = kr[:, 0]
    cache.pos[rows, slot] = positions[:, 0]
    k, v = _mla_expand(p, cache.k, cache.v, cfg, mesh)
    o = attention_core(q, k, v, positions, cache.pos, numerics, causal=True,
                       kv_chunk=decode_kv_chunk(s_max))
    return _project_out(p, o, mesh), cache


def mla_cache_specs(cfg, b: int, s: int, dtype) -> KVCache:
    m = cfg.mla
    return KVCache(k=spec((b, s, m.kv_lora_rank), dtype),
                   v=spec((b, s, m.qk_rope_head_dim), dtype),
                   pos=spec((b, s), torch.int32))


def cross_shapes(cfg) -> dict:
    d, hd, dt = cfg.d_model, cfg.head_size, pdtype(cfg)
    return {"wq": spec((d, cfg.n_heads * hd), dt),
            "wk": spec((d, cfg.n_kv_heads * hd), dt),
            "wv": spec((d, cfg.n_kv_heads * hd), dt),
            "wo": spec((cfg.n_heads * hd, d), dt)}


def cross_kv(p: dict, enc: torch.Tensor, cfg, mesh=None):
    """One layer's cross K / V (B, S_src, KV, D) from the encoder output
    (B, S_src, d): projected on every call, as the reference does (on a
    mesh this rank's KV heads, or all under :func:`_replicated_kv`)."""
    b, s, _ = enc.shape
    hd = cfg.head_size
    rep = _replicated_kv(p["wk"], cfg, mesh)
    if mesh is not None and not rep:
        enc = mesh.tp_enter(enc)
    k = (enc @ p["wk"]).reshape(b, s, -1, hd)
    v = (enc @ p["wv"]).reshape(b, s, -1, hd)
    if rep:
        k, v = mesh.tp_enter(k), mesh.tp_enter(v)
    return k, v


def cross_apply(p: dict, x: torch.Tensor, kv, cfg, numerics,
                mesh=None) -> torch.Tensor:
    """Attention from the decoder rows x (B, S, d) to the encoder's K / V:
    query and key positions all 0 and non-causal, so every key is live."""
    b, s, _ = x.shape
    hd = cfg.head_size
    if mesh is not None:
        x = mesh.tp_enter(x)
    q = (x @ p["wq"]).reshape(b, s, -1, hd)
    k, v = _attend_kv(q, *kv, cfg, mesh)
    qp = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kp = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    o = attention_core(q, k, v, qp, kp, numerics, causal=False)
    return _project_out(p, o, mesh)
