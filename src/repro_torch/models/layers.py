"""Shared model layers (twin of ``repro/models/layers.py``, the dense
decoder's subset): rmsnorm, RoPE, the SwiGLU MLP, embeddings, LM head.

Parameters are plain nested dicts of tensors in the reference's layout:
weights are (in, out) and apply as ``x @ W``.
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def apply_norm(p: dict, x: torch.Tensor, cfg, numerics) -> torch.Tensor:
    return numerics.rmsnorm(x, p["scale"].to(torch.float32)).to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., dim//2), float32."""
    freqs = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=positions.device)
                      / dim * math.log(theta))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def apply_mlp(p: dict, x: torch.Tensor, cfg, numerics) -> torch.Tensor:
    gate, up = torch.chunk(x @ p["wi"], 2, dim=-1)  # SwiGLU
    return (numerics.silu(gate) * up) @ p["wo"]


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_logits(p: dict, h: torch.Tensor) -> torch.Tensor:
    return h @ p["head"]
