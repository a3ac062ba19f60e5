"""int8 error-feedback gradient compression (twin of
``repro/optim/compress.py``).

Per-tensor symmetric int8 quantization with an error-feedback residual:
the quantization error of step t is added back to the gradient at step
t + 1, so the compression bias telescopes away. In the reference it wraps
the cross-pod all-reduce; the residual is part of the train state (and of
its checkpoints). The int8 payload is bitwise the reference's:
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import spec
from repro_torch.util.tree import tree_leaves, tree_map, unflatten_like

_F32 = torch.float32


def compress_state_shapes(param_shapes: dict) -> dict:
    return tree_map(lambda s: spec(s.shape, _F32), param_shapes)


def compress_init(params: dict) -> dict:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=_F32,
                                          device=x.device), params)


def compress_grads(grads: dict, residual: dict):
    """Returns (int8 payload, float32 scales, new residual), each a tree
    shaped as ``grads``."""
    qs, scales, rs = [], [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
        gf = g.to(_F32) + r
        scale = torch.amax(torch.abs(gf)) / 127.0 + 1e-12
        # round half to even, as jnp.round
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        qs.append(q)
        scales.append(scale)
        rs.append(gf - q.to(_F32) * scale)
    return (unflatten_like(grads, qs), unflatten_like(grads, scales),
            unflatten_like(grads, rs))


def decompress_grads(payload: dict, scales: dict) -> dict:
    return tree_map(lambda q, s: q.to(_F32) * s, payload, scales)
