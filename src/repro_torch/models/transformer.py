"""Model assembly for the decoder-only dense and MoE families (twin of
``repro/models/transformer.py``): GQA (QKV bias, sliding windows) or MLA
mixers, dense or MoE FFNs.

``layer_plan`` groups the layers into segments of one layer kind, as the
reference does: one segment of dense-MLP layers for the dense family; a
dense layer 0 (``first_dense_ff``) and then the MoE layers for DeepSeekMoE.
Parameters keep the reference's tree: ``embed/{tok,head}``,
``segments/seg<i>/0/{norm1,mixer,norm2,ffn}`` with every leaf stacked over
a leading layer axis when the segment repeats (unstacked for a one-layer
segment), and ``final_norm``; each leaf has its own dtype (the router is
float32 whatever the parameter dtype). The KV cache is the port's own
layout: one :class:`~repro_torch.models.attention.KVCache` with k/v of
shape (L, B, KVH, S, D) and pos of shape (L, B, S) over all L layers
(MLA: k (L, B, S, kv_lora), v (L, B, S, rope); a windowed cache holds
``attention.cache_rows`` rows), where the reference keeps one cache per
segment. The batch axis is axis 1 and the sequence axis the last of
``pos`` in every layout. Layers run as a Python
loop; decode updates the cache in place. Under a per-layer numerics plan
(``numerics.for_layer``) each layer takes its own numerics and the final
norm the plan's ``rest``; the loop needs no grouping of equal layers (the
reference's ``apply_segment`` groups them to scan each run once).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_shapes,
                                       embed_tokens, lm_logits, map_tree,
                                       mlp_shapes, norm_shapes, pdtype,
                                       stack_specs)
from repro_torch.models.moe import moe_block, moe_shapes


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str  # attn | mla (the SSM mixer ports with its family)
    ffn: str | None  # mlp | moe
    mlp_ff: int = 0  # dense MLP hidden size when ffn == "mlp"


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: tuple[LayerKind, ...]  # sub-layers of one stacked step
    repeat: int  # stack length


def layer_plan(cfg) -> list[Segment]:
    mixer = "mla" if cfg.mla is not None else "attn"
    if cfg.family == "moe":
        segs, n = [], cfg.n_layers
        if cfg.first_dense_ff:
            segs.append(Segment((LayerKind(mixer, "mlp",
                                           cfg.first_dense_ff),), 1))
            n -= 1
        segs.append(Segment((LayerKind(mixer, "moe"),), n))
        return segs
    if cfg.family == "dense":
        return [Segment((LayerKind(mixer, "mlp", cfg.d_ff),), cfg.n_layers)]
    raise NotImplementedError(f"model family {cfg.family!r} is not ported")


def block_shapes(kind: LayerKind, cfg) -> dict:
    mixer = (attn.mla_shapes(cfg) if kind.mixer == "mla"
             else attn.gqa_shapes(cfg))
    return {"norm1": norm_shapes(cfg), "mixer": mixer,
            "norm2": norm_shapes(cfg),
            "ffn": (moe_shapes(cfg) if kind.ffn == "moe"
                    else mlp_shapes(cfg, kind.mlp_ff))}


def segment_shapes(seg: Segment, cfg) -> dict:
    inner = {str(i): block_shapes(k, cfg) for i, k in enumerate(seg.pattern)}
    return stack_specs(inner, seg.repeat) if seg.repeat > 1 else inner


def param_shapes(cfg) -> dict:
    """The reference's ``model_shapes`` for the decoder-only dense and MoE
    families: a tree of :class:`~repro_torch.models.layers.Spec` leaves."""
    return {"embed": embed_shapes(cfg),
            "segments": {f"seg{i}": segment_shapes(seg, cfg)
                         for i, seg in enumerate(layer_plan(cfg))},
            "final_norm": norm_shapes(cfg)}


def init_params(cfg, seed: int = 0, device: str | torch.device = "cuda"
                ) -> dict:
    """Random parameters with the reference's init rules (``init_tree``):
    truncated-normal(-2, 2) scaled by 1/sqrt(fan_in) (fan_in = the
    second-to-last dim), unit norm scales, each leaf in its own dtype;
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``.
    A leaf of rank >= 3 is drawn one slice of its leading (layer or expert)
    axis at a time, so no float32 draw holds more than one layer."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def one(name: str, sp) -> torch.Tensor:
        shape, dt = sp
        if name.endswith("scale"):
            return torch.ones(shape, dtype=dt, device=dev)
        std = 1.0 / math.sqrt(max(shape[-2], 1))
        out = torch.empty(shape, dtype=dt, device=dev)
        for sl in (out if len(shape) >= 3 else (out,)):
            w = torch.empty(sl.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            sl.copy_(w.mul_(std))
            del w  # freed before the next slice's draw is allocated
        return out

    return map_tree(one, param_shapes(cfg))


@functools.lru_cache(maxsize=None)
def layer_slots(cfg) -> tuple:
    """Per global layer index: (segment name, pattern key, index in the
    segment's stack or None for an unstacked segment, LayerKind)."""
    out = []
    for s, seg in enumerate(layer_plan(cfg)):
        for r in range(seg.repeat):
            for j, kind in enumerate(seg.pattern):
                out.append((f"seg{s}", str(j),
                            r if seg.repeat > 1 else None, kind))
    return tuple(out)


def layer_params(p: dict, cfg, i: int):
    """Layer ``i``'s kind and parameters (views into its segment's
    stack)."""
    seg, j, r, kind = layer_slots(cfg)[i]
    tree = p["segments"][seg][j]
    return kind, (tree if r is None else map_tree(lambda _n, t: t[r], tree))


def cache_specs(cfg, b: int, cache_len: int) -> attn.KVCache:
    """One layer's cache leaves (every layer of a ported family has the
    same mixer): ``gqa_cache_specs`` (a windowed ring of
    ``attention.cache_rows`` rows) or ``mla_cache_specs``."""
    fn = (attn.mla_cache_specs if cfg.mla is not None
          else attn.gqa_cache_specs)
    return fn(cfg, b, cache_len, pdtype(cfg))


def init_cache(cfg, b: int, cache_len: int,
               device: str | torch.device = "cuda") -> attn.KVCache:
    """The empty stacked cache: zeros, positions -1, a layer axis first."""
    dev = resolve(device)
    return attn.KVCache(*(
        torch.full((cfg.n_layers, *sp.shape), -1 if sp.dtype == torch.int32
                   else 0, dtype=sp.dtype, device=dev)
        for sp in cache_specs(cfg, b, cache_len)))


def splice_cache(cfg, pool: attn.KVCache, one: attn.KVCache,
                 slot: int) -> attn.KVCache:
    """Write one request's prefilled cache (batch size 1) into ``slot`` of
    the pool along the *batch* axis (axis 1: axis 0 is the layer stack),
    in place."""
    for dst, src in zip(pool, one):
        dst[:, slot] = src[:, 0].to(dst.dtype)
    return pool


def backbone(p: dict, h, positions, cfg, numerics, mode: str,
             caches: attn.KVCache | None = None, cache_len: int = 0,
             pos=None):
    """Run every layer and the final norm. ``mode``: "prefill" (returns the
    new stacked cache) or "decode" (updates ``caches`` in place).
    ``numerics`` is one backend for every layer, or a plan-resolved object
    whose ``for_layer(i)`` gives layer ``i``'s (the final norm then runs
    under the object itself: the plan's ``rest``)."""
    per_layer = hasattr(numerics, "for_layer")
    new = []
    for i in range(cfg.n_layers):
        num = numerics.for_layer(i) if per_layer else numerics
        kind, lp = layer_params(p, cfg, i)
        x = apply_norm(lp["norm1"], h, cfg, num)
        mla = kind.mixer == "mla"
        if mode == "prefill":
            y, c = (attn.mla_prefill if mla else attn.gqa_prefill)(
                lp["mixer"], x, positions, cfg, num, cache_len)
            new.append(c)
        elif mode == "decode":
            layer = attn.KVCache(*(t[i] for t in caches))
            y, _ = (attn.mla_decode if mla else attn.gqa_decode)(
                lp["mixer"], x, pos, layer, cfg, num)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        h = h + y
        x2 = apply_norm(lp["norm2"], h, cfg, num)
        if kind.ffn == "moe":
            h = h + moe_block(lp["ffn"], x2, cfg, num)
        else:
            h = h + apply_mlp(lp["ffn"], x2, cfg, num)
    h = apply_norm(p["final_norm"], h, cfg, numerics)
    if mode == "prefill":
        caches = attn.KVCache(*(torch.stack(t) for t in zip(*new)))
    return h, caches


def prefill(p: dict, tokens: torch.Tensor, cfg, numerics, cache_len: int):
    """Process the prompt; returns (last-position logits (B, 1, V), cache)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    h = embed_tokens(p["embed"], tokens)
    h, caches = backbone(p, h, positions, cfg, numerics, "prefill",
                         cache_len=cache_len)
    return lm_logits(p["embed"], h[:, -1:]), caches


def mask_cache_tail(caches: attn.KVCache, true_lens) -> attn.KVCache:
    """Mark every cache row at or past each batch row's true length as
    empty (``pos = -1``, the ``init_cache`` sentinel the attention mask
    treats as dead).

    A padded (bucketed) prefill writes the pad suffix's K/V rows with live
    positions; a later decode step would attend to them. The K/V rows
    themselves stay: with ``pos`` at -1 the mask drops them, and decode
    overwrites row ``p`` when the sequence reaches position ``p``. The
    (B, S) validity mask broadcasts over the leading layer axis."""
    pos = caches.pos
    lens = torch.as_tensor(true_lens, dtype=torch.int32, device=pos.device)
    valid = (torch.arange(pos.shape[-1], dtype=torch.int32,
                          device=pos.device) < lens[:, None])
    return attn.KVCache(caches.k, caches.v, torch.where(valid, pos, -1))


def prefill_padded(p: dict, tokens: torch.Tensor, true_lens, cfg, numerics,
                   cache_len: int):
    """Bucketed prefill: ``tokens`` is (B, S_bucket) with each row
    right-padded to the bucket length and ``true_lens`` (B,) the real
    prompt lengths (a tensor on the tokens' device, or a sequence).
    Returns (per-row logits at position ``true_len - 1`` (B, 1, V), the
    cache with the pad tails masked dead).

    Positions run 0..S_bucket-1 as a full-length prefill's: causality makes
    every row below its true length compute what an exact-length prefill
    of that prompt computes, so the gathered logits match the exact path
    and :func:`mask_cache_tail` is the only repair the cache needs. An MoE
    layer sizes its expert capacity from the bucket length, as the
    reference's does, so its padded prefill is not the exact-length one
    once the two capacities differ. Refused, as the reference refuses:
    encoder / frontend configs, sliding windows, SSM mixers."""
    if (getattr(cfg, "encoder", None) is not None
            or getattr(cfg, "frontend", None) is not None):
        raise ValueError("prefill_padded: encoder/frontend configs must "
                         "use exact-length prefill")
    if getattr(cfg, "sliding_window", None) is not None:
        raise ValueError("prefill_padded: sliding-window caches wrap; use "
                         "exact-length prefill")
    if any(k.mixer == "ssm" for seg in layer_plan(cfg) for k in seg.pattern):
        raise ValueError("prefill_padded: SSM state is cumulative, a pad "
                         "suffix corrupts it; use exact-length prefill")
    b, s = tokens.shape
    lens = torch.as_tensor(true_lens, dtype=torch.int32,
                           device=tokens.device)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    h = embed_tokens(p["embed"], tokens)
    h, caches = backbone(p, h, positions, cfg, numerics, "prefill",
                         cache_len=cache_len)
    idx = (lens.to(torch.int64) - 1).reshape(b, 1, 1).expand(b, 1,
                                                             h.shape[-1])
    rows = torch.gather(h, 1, idx)
    return lm_logits(p["embed"], rows), mask_cache_tail(caches, lens)


def extract_cache_row(cfg, pool: attn.KVCache, i) -> attn.KVCache:
    """Batch row ``i`` of a pooled cache, keeping the batch axis (axis 1:
    axis 0 is the layer stack): the inverse of :func:`splice_cache`. ``i``
    may be a device index tensor."""
    if isinstance(i, torch.Tensor):
        idx = i.reshape(1).to(torch.int64)
        return attn.KVCache(*(t.index_select(1, idx) for t in pool))
    return attn.KVCache(*(t[:, i:i + 1] for t in pool))


def splice_cache_rows(cfg, pool: attn.KVCache, rows: attn.KVCache,
                      slots: torch.Tensor) -> attn.KVCache:
    """Write the P batch rows of ``rows`` into pool slots ``slots`` (a (P,)
    device index tensor of distinct slots) in place: P of
    :func:`splice_cache` of :func:`extract_cache_row` in one op per leaf,
    with the slots read on the device (what a CUDA graph replays for any
    slot assignment)."""
    idx = slots.to(torch.int64)
    for dst, src in zip(pool, rows):
        dst.index_copy_(1, idx, src.to(dst.dtype))
    return pool


def decode_step(p: dict, token: torch.Tensor, pos, caches: attn.KVCache, cfg,
                numerics):
    """token: (B, 1) int; pos: scalar or (B,) per-slot positions. Returns
    (logits (B, 1, V), caches updated in place)."""
    b = token.shape[0]
    pos, _ = attn._decode_positions(pos, b, token.device)
    h = embed_tokens(p["embed"], token)
    h, caches = backbone(p, h, None, cfg, numerics, "decode", caches=caches,
                         pos=pos)
    return lm_logits(p["embed"], h), caches
