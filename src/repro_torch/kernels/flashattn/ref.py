"""Plain PyTorch versions of the flash attention kernels: the library-bound
one (twin of ``repro/kernels/flashattn/ref.py`` ``flash_attention_lib_ref``
and of the reference wrapper's ``use_kernel=False`` path) and the per-table
one (twin of ``flash_attention_ref``, the oracle of ``attention_fused``).

``flash_attention_lib_ref`` is unchunked: the scores of a whole (query,
key) block are formed at once, so the online-softmax correction never runs.
A chunked kernel differs from it by table ulps (each correction is itself a
table read), not by float eps; ``repro_torch.numerics.ops.softmax_ulp_bound``
states the scale. ``flash_attention_lib_chunked_ref`` is the twin of the
reference kernel's ``_flash_loop`` itself, tile by tile, with its
``chunk_live`` skip per query tile when ``block_q`` is given: against a
kernel with the same key and query tiles it differs only where float
reassociation flips a table code. The skip matters once the exp2neg table's
tab(0) is not exactly 2^out_bits (the segmented default gives 8191 at 13
bits): a tile that leaves the running max unchanged still scales l and the
accumulator by tab(0) * 2^-out_bits, so a skipped tile and a processed one
differ by up to one reciprocal-table step. The 10-bit exp2neg design has
tab(0) = 8191 at 13 bits too. ``flash_attention_chunked_ref`` is the same
tile-by-tile twin on two per-table designs with ``arange`` positions.

``flash_attention_ref`` is the reference's per-table oracle: unchunked, and
through the *unfused* glue of ``numerics.ops`` (scale after Q.K^T, the
``frexp`` split for 1/l), so it differs from the per-table kernel by table
ulps too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.interp.ref import LOG2E, table_exp_neg, table_recip
from repro_torch.kernels.softmax.ops import _meta
from repro_torch.numerics.ops import approx_exp_neg, approx_recip_pos

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


def _chunk_live(q_pos, kv_pos, causal, window, block_q):
    """(N, Sq, 1) bool: the reference's ``chunk_live`` of one key tile
    (``kv_pos`` (N, BK)) for each query tile of ``block_q`` rows: some key
    slot is live, and, if causal, the earliest live key is not past the
    tile's last query position; with a window, the latest key is inside
    the window of the tile's earliest live query."""
    n, sq = q_pos.shape
    imax = 2**31 - 1
    n_tiles = -(-sq // block_q)
    qp = torch.full((n, n_tiles * block_q), -1, dtype=torch.int64,
                    device=q_pos.device)
    qp[:, :sq] = q_pos
    qp = qp.reshape(n, n_tiles, block_q)
    kp = kv_pos.to(torch.int64)
    need = (kp >= 0).any(-1, keepdim=True).expand(n, n_tiles)
    if causal:
        kmin = torch.where(kp < 0, imax, kp).amin(-1, keepdim=True)
        need = need & (kmin <= qp.amax(-1))
    if window is not None:
        qmin = torch.where(qp < 0, imax, qp).amin(-1)
        need = need & (kp.amax(-1, keepdim=True) > qmin - window)
    return need.repeat_interleave(block_q, dim=1)[:, :sq, None]


def flash_attention_lib_chunked_ref(q, k, v, q_pos, kv_pos, coeffs,
                                    exp_meta: dict, recip_meta: dict, *,
                                    causal: bool = True,
                                    window: int | None = None,
                                    scale: float | None = None,
                                    block_k: int = 64,
                                    block_q: int | None = None,
                                    kv_splits: int = 1) -> torch.Tensor:
    """Twin of the reference's ``_flash_loop`` over ``block_k``-key tiles
    (same operands as :func:`flash_attention_lib_ref`): q scaled before the
    product, the running max floored at M_FLOOR, p and the correction from
    the exp2neg table, p cast to V's dtype for P.V, 1/max(l, 1e-30) from the
    recip table. Keys past Sk do not exist (no padded tail). ``block_q``:
    skip a key tile for a tile of that many query positions where it is
    dead (``_chunk_live``), as the reference's kernel and the port's do;
    None runs every tile for every row. ``kv_splits``: the kernel's key
    split (``kernel.kv_splits``): the tile loop runs per range of
    ``ceil(n_tiles / kv_splits)`` tiles and the ranges are combined through
    the exp2neg table in range order (:func:`_combine`)."""
    return _flash_chunks(q, k, v, q_pos, kv_pos, (coeffs, exp_meta),
                         (coeffs, recip_meta), causal=causal, window=window,
                         scale=scale, block_k=block_k, block_q=block_q,
                         kv_splits=kv_splits)


def _flash_chunks(q, k, v, q_pos, kv_pos, exp_tab, recip_tab, *, causal,
                  window, scale, block_k, block_q,
                  kv_splits=1) -> torch.Tensor:
    """The tile loop of :func:`flash_attention_lib_chunked_ref`; each table
    is a (coeffs, meta) pair for ``table_exp_neg`` / ``table_recip``."""
    n, sq, d = q.shape
    scale = (d ** -0.5) if scale is None else scale
    qf = q.to(torch.float32) * scale
    n_kt = -(-k.shape[1] // block_k)
    per = -(-n_kt // kv_splits) if n_kt else 0
    if kv_splits > 1 and (kv_splits - 1) * per >= n_kt:
        raise ValueError(f"{kv_splits} key splits of {n_kt} tiles leave one "
                         f"empty")
    parts = [_tile_loop(qf, k, v, q_pos, kv_pos, exp_tab, causal, window,
                        block_k, block_q, t * per, min(t * per + per, n_kt))
             for t in range(kv_splits)]
    if kv_splits == 1:
        _, l, acc = parts[0]
    else:
        l, acc = _combine(parts, exp_tab)
    recip = table_recip(torch.clamp(l, min=1e-30), *recip_tab)
    return (acc * recip).to(v.dtype)


def _tile_loop(qf, k, v, q_pos, kv_pos, exp_tab, causal, window, block_k,
               block_q, t0, t1):
    """(m, l, acc) of the online softmax over key tiles [t0, t1)."""
    n, sq, _ = qf.shape
    m = torch.full((n, sq, 1), M_FLOOR, dtype=torch.float32, device=qf.device)
    l = torch.zeros((n, sq, 1), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((n, sq, v.shape[-1]), dtype=torch.float32,
                      device=qf.device)
    for k0 in range(t0 * block_k, t1 * block_k, block_k):
        sl = slice(k0, k0 + block_k)
        s = torch.einsum("nqd,nkd->nqk", qf, k[:, sl].to(torch.float32))
        s = torch.where(_mask(q_pos, kv_pos[:, sl], causal, window), s,
                        torch.full_like(s, NEG))
        m_new = torch.clamp(torch.maximum(m, s.amax(-1, keepdim=True)),
                            min=M_FLOOR)
        p = table_exp_neg((m_new - s) * LOG2E, *exp_tab)
        corr = table_exp_neg((m_new - m) * LOG2E, *exp_tab)
        pv = torch.einsum("nqk,nkd->nqd", p.to(v.dtype).to(torch.float32),
                          v[:, sl].to(torch.float32))
        acc_new = acc * corr + pv
        l_new = l * corr + p.sum(-1, keepdim=True)
        if block_q is None:
            m, l, acc = m_new, l_new, acc_new
        else:
            live = _chunk_live(q_pos, kv_pos[:, sl], causal, window, block_q)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live, acc_new, acc)
    return m, l, acc


def _combine(parts, exp_tab):
    """The key splits' (m_s, l_s, acc_s) into one (l, acc), as the kernel's
    ``flash_attn_combine``: m = max_s m_s, c_s = exp2neg((m - m_s) *
    LOG2E), l = sum_s l_s c_s and acc = sum_s acc_s c_s in split order. A
    split whose tiles were all skipped (m_s = M_FLOOR, l_s = 0, acc_s = 0)
    adds exactly 0."""
    m = parts[0][0]
    for m_s, _, _ in parts[1:]:
        m = torch.maximum(m, m_s)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m_s, l_s, acc_s in parts:
        c = table_exp_neg((m - m_s) * LOG2E, *exp_tab)
        l = l + l_s * c
        acc = acc + acc_s * c
    return l, acc


def _arange_pos(n: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(n, s)


def flash_attention_ref(q, k, v, exp_design, recip_design, *,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """The per-table oracle: q (N, Sq, D), k and v (N, Sk, D); causal by
    index (query row i sees keys j <= i). Unchunked, scores scaled after
    Q.K^T, p = ``approx_exp_neg(s - m)`` and 1/l = ``approx_recip_pos``,
    whose tables read through ``table_eval_int`` (the ``interp_eval``
    kernel for CUDA tensors)."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("nqd,nkd->nqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qp >= kp, s, torch.full_like(s, NEG))
    m = torch.clamp(s.amax(-1, keepdim=True), min=M_FLOOR)
    p = approx_exp_neg(s - m, exp_design)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("nqk,nkd->nqd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return (o * approx_recip_pos(torch.clamp(l, min=1e-30), recip_design)
            ).to(v.dtype)


def flash_attention_chunked_ref(q, k, v, exp_design, recip_design, *,
                                causal: bool = True,
                                scale: float | None = None,
                                block_k: int = 64,
                                block_q: int | None = None,
                                kv_splits: int = 1) -> torch.Tensor:
    """Tile-by-tile twin of the per-table kernel (the reference's
    ``_flash_kernel`` over ``_flash_loop``): :func:`flash_attention_lib_
    chunked_ref`'s loop with ``arange`` positions and each table read from
    its design's own (2^R, 3) rows. With the kernel's ``query_tile`` as
    ``block_q`` it skips exactly the key tiles the kernel skips: those
    strictly above the diagonal of a query tile; ``kv_splits`` as the
    kernel's."""
    n, sq, _ = q.shape
    dev = q.device
    return _flash_chunks(
        q, k, v, _arange_pos(n, sq, dev), _arange_pos(n, k.shape[1], dev),
        (exp_design.device_coeffs(dev), _meta(exp_design)),
        (recip_design.device_coeffs(dev), _meta(recip_design)),
        causal=causal, window=None, scale=scale, block_k=block_k,
        block_q=block_q, kv_splits=kv_splits)


def attention_fused_ref(q, k, v, exp_design, recip_design, *,
                        causal: bool = True, scale: float | None = None,
                        block_k: int | None = None,
                        block_q: int | None = None,
                        kv_splits: int = 1) -> torch.Tensor:
    """The per-table plain version at ``attention_fused``'s signature: q, k,
    v (B, S, H, D) with as many KV heads as query heads. ``block_k``
    selects the tile-by-tile twin instead of the unchunked oracle,
    ``block_q`` its per-query-tile skip and ``kv_splits`` its key split."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qn = q.transpose(1, 2).reshape(b * h, sq, d)
    kn = k.transpose(1, 2).reshape(b * h, sk, d)
    vn = v.transpose(1, 2).reshape(b * h, sk, d)
    kw = dict(causal=causal, scale=scale)
    o = (flash_attention_ref(qn, kn, vn, exp_design, recip_design, **kw)
         if block_k is None else
         flash_attention_chunked_ref(qn, kn, vn, exp_design, recip_design,
                                     block_k=block_k, block_q=block_q,
                                     kv_splits=kv_splits, **kw))
    return o.reshape(b, h, sq, d).transpose(1, 2)


def attention_fused_library_ref(q, k, v, library, *, causal: bool = True,
                                scale: float | None = None,
                                window: int | None = None, q_pos=None,
                                kv_pos=None,
                                block_k: int | None = None,
                                block_q: int | None = None,
                                kv_splits: int = 1) -> torch.Tensor:
    """The plain version at the wrapper's signature: q (B, Sq, H, D), k / v
    (B, Sk, KVH, D*), positions (B, S*); grouped KV heads are expanded to
    one stripe per query head (query head h reads KV head h // g).
    ``block_k`` selects the tile-by-tile twin instead of the unchunked
    oracle, ``block_q`` its per-query-tile skip of dead key tiles and
    ``kv_splits`` its key split."""
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
         flash_attention_lib_chunked_ref(*args, block_k=block_k,
                                         block_q=block_q,
                                         kv_splits=kv_splits, **kw))
    return o.reshape(b, h, sq, dv).transpose(1, 2)
