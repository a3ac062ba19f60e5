"""Model assembly, dense decoder path (twin of
``repro/models/transformer.py``).

Parameters keep the reference's tree: ``embed/{tok,head}``,
``segments/seg0/0/{norm1,mixer,norm2,ffn}`` with every leaf stacked over a
leading layer axis, and ``final_norm``. The KV cache is one
:class:`~repro_torch.models.attention.KVCache` with k/v of shape
(L, B, KVH, S, D) and pos of shape (L, B, S), the reference's stacked
segment cache. Layers run as a Python loop; decode updates the cache in
place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       lm_logits, pdtype)


def param_shapes(cfg) -> dict:
    """The reference's ``model_shapes`` for the dense family, layer-stacked."""
    d, hd, L, f = cfg.d_model, cfg.head_size, cfg.n_layers, cfg.d_ff
    mixer = {"wq": (L, d, cfg.n_heads * hd), "wk": (L, d, cfg.n_kv_heads * hd),
             "wv": (L, d, cfg.n_kv_heads * hd), "wo": (L, cfg.n_heads * hd, d)}
    embed = {"tok": (cfg.vocab_size, d), "head": (d, cfg.vocab_size)}
    layer = {"norm1": {"scale": (L, d)}, "mixer": mixer,
             "norm2": {"scale": (L, d)},
             "ffn": {"wi": (L, d, 2 * f), "wo": (L, f, d)}}
    return {"embed": embed, "segments": {"seg0": {"0": layer}},
            "final_norm": {"scale": (d,)}}


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def init_params(cfg, seed: int = 0, device: str | torch.device = "cuda"
                ) -> dict:
    """Random parameters with the reference's init rules (``init_tree``):
    truncated-normal(-2, 2) scaled by 1/sqrt(fan_in) (fan_in = the
    second-to-last dim), unit norm scales; drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, one layer slice
    at a time so the float32 draw never holds more than one layer."""
    dev = resolve(device)
    dt = pdtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def one(name: str, shape: tuple) -> torch.Tensor:
        if name.endswith("scale"):
            return torch.ones(shape, dtype=dt, device=dev)
        std = 1.0 / math.sqrt(max(shape[-2], 1))
        out = torch.empty(shape, dtype=dt, device=dev)
        for sl in (out if len(shape) == 3 else (out,)):
            w = torch.empty(sl.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            sl.copy_(w * std)
        return out

    return _map_tree(one, param_shapes(cfg))


def layer_params(p: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked segment tree (views)."""
    return _map_tree(lambda _n, t: t[i], p["segments"]["seg0"]["0"])


def init_cache(cfg, b: int, cache_len: int,
               device: str | torch.device = "cuda") -> attn.KVCache:
    dev = resolve(device)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, cache_len, cfg.head_size)
    return attn.KVCache(
        torch.zeros(shape, dtype=pdtype(cfg), device=dev),
        torch.zeros(shape, dtype=pdtype(cfg), device=dev),
        torch.full((cfg.n_layers, b, cache_len), -1, dtype=torch.int32,
                   device=dev))


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
    new stacked cache) or "decode" (updates ``caches`` in place)."""
    new = []
    for i in range(cfg.n_layers):
        lp = layer_params(p, i)
        x = apply_norm(lp["norm1"], h, cfg, numerics)
        if mode == "prefill":
            y, c = attn.gqa_prefill(lp["mixer"], x, positions, cfg, numerics,
                                    cache_len)
            new.append(c)
        elif mode == "decode":
            layer = attn.KVCache(*(t[i] for t in caches))
            y, _ = attn.gqa_decode(lp["mixer"], x, pos, layer, cfg, numerics)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        h = h + y
        x2 = apply_norm(lp["norm2"], h, cfg, numerics)
        h = h + apply_mlp(lp["ffn"], x2, cfg, numerics)
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
