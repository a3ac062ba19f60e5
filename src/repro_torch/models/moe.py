"""Mixture-of-experts block (twin of ``repro/models/moe.py``): token-choice
top-k routing with capacity-bounded per-example dispatch.

The router's logits are a float32 product and its softmax goes through the
numerics backend (``MoEConfig.router_numerics``), so under interp-fused
numerics the routing probabilities come from the ``softmax_lib`` kernel.
Each example dispatches its S * k token copies into a (B, E, C + 1, d)
buffer at their position in the expert (a cumsum over the example's own
assignments); row C is the overflow scratch row, zeroed at the combine by
``keep``. The expert products fold the batch into the rows, so each expert's
weights are read once per call. On the CPU in float32 this computes what the
reference computes; in bf16 on the card the expert products round their
outputs to bf16 where the reference keeps float32.

``load_balance_loss_from_probs`` is the training path's Switch-style aux
loss from the same routing pass's probabilities.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import pdtype, spec


def moe_shapes(cfg) -> dict:
    m, d, dt = cfg.moe, cfg.d_model, pdtype(cfg)
    out = {
        "router": spec((d, m.n_experts), torch.float32),
        "wi": spec((m.n_experts, d, 2 * m.d_expert), dt),  # SwiGLU gate+up
        "wo": spec((m.n_experts, m.d_expert, d), dt),
    }
    if m.n_shared:
        out["shared_wi"] = spec((d, 2 * m.n_shared * m.d_expert), dt)
        out["shared_wo"] = spec((m.n_shared * m.d_expert, d), dt)
    return out


def _capacity(seq: int, cfg) -> int:
    m = cfg.moe
    c = int(seq * m.top_k * m.capacity_factor / m.n_experts)
    return max(min(c, seq * m.top_k), 4)


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis in descending order, ties
    taken lower index first (as ``jax.lax.top_k``): a stable descending
    sort, where ``torch.topk`` promises no order among equal values. Table
    softmax probabilities are quantized, so exact ties between experts
    occur."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, x: torch.Tensor, cfg, numerics):
    """Router probabilities (B, S, E) float32, and the top-k expert ids and
    renormalized gates (B, S, K)."""
    m = cfg.moe
    logits = x.to(torch.float32) @ p["router"]
    probs = (numerics.softmax(logits, axis=-1) if m.router_numerics
             else torch.softmax(logits, dim=-1))
    gate, idx = top_k(probs, m.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, idx, gate


def moe_block(p: dict, x: torch.Tensor, cfg, numerics,
              return_probs: bool = False, mesh=None):
    """x: (B, S, d) -> (B, S, d). Token copies over an example's capacity
    are dropped (they fall through on the residual path). On a mesh the
    router and the dispatch run on every ``tp`` rank alike, the experts'
    ``wi`` / ``wo`` hold this rank's ``d_expert`` columns / rows (as the
    shared expert's), and their outputs are summed over ``tp``."""
    m = cfg.moe
    b, s, d = x.shape
    e_n, k = m.n_experts, m.top_k
    cap = _capacity(s, cfg)
    probs, idx, gate = route(p, x, cfg, numerics)

    # per-example dispatch plan: position of each copy inside its expert
    flat_e = idx.reshape(b, s * k)  # (B, SK) expert ids, token-major
    onehot = F.one_hot(flat_e, e_n).to(torch.int32)  # (B, SK, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, pos_in_e, cap)  # overflow -> scratch row C

    # dispatch into (B, E, C + 1, d); row C collects the dropped copies
    # (B, SK, d) token-major: each token's k copies side by side
    xk = x[:, :, None].expand(b, s, k, d).reshape(b, s * k, d)
    buf = torch.zeros((b, e_n, cap + 1, d), dtype=x.dtype, device=x.device)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf.index_put_((bidx, flat_e, slot), xk, accumulate=True)

    # expert SwiGLU: batch folded into the rows, one product per expert
    rows = buf.permute(1, 0, 2, 3).reshape(e_n, b * (cap + 1), d)
    if mesh is not None:
        rows = mesh.tp_enter(rows)
    h = torch.bmm(rows, p["wi"])
    gate_h, up = torch.chunk(h, 2, dim=-1)
    h = (numerics.silu(gate_h) * up).to(x.dtype)
    out_buf = torch.bmm(h, p["wo"])
    if mesh is not None:
        out_buf = mesh.tp_sum(out_buf)
    out_buf = out_buf.reshape(e_n, b, cap + 1, d)

    # combine: gather each copy's expert output, weight by keep * gate
    tok_out = out_buf[flat_e, bidx, slot].to(torch.float32)  # (B, SK, d)
    tok_out = tok_out * (keep * gate.reshape(b, s * k))[..., None]
    y = tok_out.reshape(b, s, k, d).sum(dim=2).to(x.dtype)

    if m.n_shared:
        xs = x if mesh is None else mesh.tp_enter(x)
        gs, us = torch.chunk(xs @ p["shared_wi"], 2, dim=-1)
        ys = (numerics.silu(gs) * us) @ p["shared_wo"]
        if mesh is not None:
            ys = mesh.tp_sum(ys)
        y = y + ys.to(x.dtype)
    if return_probs:
        return y, probs
    return y


def load_balance_loss_from_probs(probs: torch.Tensor, cfg,
                                 mesh=None) -> torch.Tensor:
    """Switch-style load-balance aux loss from the routing pass's probs (B,
    S, E): E * sum_e (mean prob of e) * (mean top-k count of e). The top-k
    is :func:`top_k`'s stable descending sort, as the routing takes it. On
    a mesh whose ``data`` axis splits the batch the counts are the global
    batch's (averaged over ``data``; they carry no gradient), so the
    ranks' losses and gradients average to the global batch's."""
    m = cfg.moe
    pe = probs.reshape(-1, m.n_experts)
    me = pe.mean(0)
    _, idx = top_k(pe, m.top_k)
    ce = torch.mean(F.one_hot(idx, m.n_experts).to(torch.float32).sum(1), 0)
    if mesh is not None and "data" in mesh.shape:
        ce = mesh.all_reduce(ce.detach(), "data") / mesh.shape["data"]
    return m.n_experts * torch.sum(me * ce)
