"""Shared model layers (twin of ``repro/models/layers.py``): shape specs,
their parameter count and initialization (``count_params``, ``init_tree``),
RMSNorm and LayerNorm, RoPE, the MLP (SwiGLU, GELU or squared ReLU),
embeddings, the LM head (tied or not).

Parameters are plain nested dicts of tensors in the reference's layout:
weights are (in, out) and apply as ``x @ W``. A shape tree is a nested dict
of :class:`Spec` leaves, each with its own dtype, as the reference's
``jax.ShapeDtypeStruct`` leaves.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pdtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


class Spec(NamedTuple):
    """One parameter leaf's shape and dtype."""

    shape: tuple
    dtype: torch.dtype


def spec(shape, dtype: torch.dtype) -> Spec:
    return Spec(tuple(int(s) for s in shape), dtype)


def map_tree(fn, tree: dict, path: tuple = ()) -> dict:
    """Apply ``fn(path_string, leaf)`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn("/".join(path), tree)


def stack_specs(tree: dict, n: int) -> dict:
    """Prepend a layer dimension to every leaf (stacked layer segments)."""
    return map_tree(lambda _n, s: spec((n, *s.shape), s.dtype), tree)


def count_params(shapes: dict) -> int:
    """Elements over every leaf of a :class:`Spec` tree."""
    n = 0

    def add(_name, sp):
        nonlocal n
        n += math.prod(sp.shape)
    map_tree(add, shapes)
    return n


def init_rule(name: str, shape: tuple):
    """The reference's ``init_tree`` rule for the leaf at path ``name`` of
    ``shape``: ``"ones"`` (norm scales, ``d_skip``), ``"zeros"`` (``bias``,
    ``b``, ``conv_b``, ``dt_bias``), ``"a_log"`` (log(1..H) along the last
    axis: A = -exp(a_log) spans the heads' decay rates), or the std of a
    truncated-normal(-2, 2) draw, 1/sqrt(fan_in) with fan_in the
    second-to-last dim (the only dim of a 1-D leaf: the projector's ``b1``
    / ``b2`` are drawn, as the reference's suffix test draws them; the
    learned ``pos`` table's fan-in is its ``max_pos`` rows). Matched on the
    leaf's own name: the reference's suffix test also catches MLA's
    ``wq_b`` / ``wkv_b``, which the port draws (zero up-projections would
    void MLA's attention)."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "a_log":
        return "a_log"
    if leaf in ("d_skip", "scale", "gamma"):
        return "ones"
    if leaf in ("bias", "b", "conv_b", "dt_bias"):
        return "zeros"
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_tree(shapes: dict, seed: int = 0,
              device: str | torch.device = "cuda") -> dict:
    """Materialize a :class:`Spec` tree by :func:`init_rule`, each leaf in
    its own dtype, drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (so the draws are the port's own, not the reference's; tests
    carry the reference's over with ``convert.params_from_jax``). A leaf of
    rank >= 3 is drawn one slice of its leading (layer or expert) axis at a
    time, so no float32 draw holds more than one layer."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def one(name: str, sp: Spec) -> torch.Tensor:
        shape, dt = sp
        rule = init_rule(name, shape)
        if rule == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        if rule == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        if rule == "a_log":
            row = torch.log(torch.arange(1, shape[-1] + 1,
                                         dtype=torch.float32, device=dev))
            return row.expand(shape).to(dt).contiguous()
        std = rule
        out = torch.empty(shape, dtype=dt, device=dev)
        for sl in (out if len(shape) >= 3 else (out,)):
            w = torch.empty(sl.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            sl.copy_(w.mul_(std))
            del w  # freed before the next slice's draw is allocated
        return out

    return map_tree(one, shapes)


def norm_shapes(cfg) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": spec((cfg.d_model,), pdtype(cfg)),
                "bias": spec((cfg.d_model,), pdtype(cfg))}
    return {"scale": spec((cfg.d_model,), pdtype(cfg))}


def mlp_shapes(cfg, d_ff: int | None = None) -> dict:
    """SwiGLU (``act="silu"``): gate + up, then down; other activations one
    up projection. ``d_ff`` overrides ``cfg.d_ff`` (the dense layer 0 of
    DeepSeekMoE takes ``first_dense_ff``)."""
    d, dt, f = cfg.d_model, pdtype(cfg), d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {"wi": spec((d, 2 * f), dt), "wo": spec((f, d), dt)}
    return {"wi": spec((d, f), dt), "wo": spec((f, d), dt)}


def embed_shapes(cfg) -> dict:
    dt = pdtype(cfg)
    out = {"tok": spec((cfg.vocab_size, cfg.d_model), dt)}
    if not cfg.tie_embeddings:
        out["head"] = spec((cfg.d_model, cfg.vocab_size), dt)
    return out


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm in float32 with plain ``torch.rsqrt`` (eps 1e-5), cast
    back to x's dtype: the reference computes ``jax.lax.rsqrt`` under every
    numerics backend, so no backend's table is read here."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * scale + bias).to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, cfg, numerics) -> torch.Tensor:
    """LayerNorm (:func:`layer_norm`) under ``cfg.norm == "layernorm"``;
    else RMSNorm with the scale as stored: the reference casts it to
    float32 first, and every backend promotes it to float32 itself (bf16
    -> f32 is exact, so the result is bitwise the same); the fused kernel
    reads it in its own dtype, so the served norm is one device op."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return numerics.rmsnorm(x, p["scale"]).to(x.dtype)


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


def tp_cols(t: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """This rank's ``n`` last-axis columns of ``t``: ``t`` itself where it
    already has ``n`` (no mesh, or a local shard), else the ``tp`` rank's
    slice of a leaf the specs replicate (a QKV bias, the projector's
    ``b1``), whose gradient is then summed over ``tp``."""
    if t.shape[-1] == n:
        return t
    return mesh.tp_enter(t).narrow(-1, mesh.tp_rank * n, n)


def apply_mlp(p: dict, x: torch.Tensor, cfg, numerics,
              mesh=None) -> torch.Tensor:
    """The MLP; on a mesh ``wi`` is column-parallel (this rank's gate and up
    columns) and ``wo`` row-parallel, summed over ``tp``."""
    if mesh is not None:
        x = mesh.tp_enter(x)
    h = x @ p["wi"]
    if cfg.act == "silu":
        gate, up = torch.chunk(h, 2, dim=-1)  # SwiGLU
        h = numerics.silu(gate) * up
    elif cfg.act == "gelu":
        h = numerics.gelu(h)
    elif cfg.act == "relu2":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(cfg.act)
    y = h @ p["wo"]
    return y if mesh is None else mesh.tp_sum(y)


def embed_tokens(p: dict, tokens: torch.Tensor, mesh=None,
                 vocab: int | None = None) -> torch.Tensor:
    """The token rows. On a mesh whose ``tp`` splits the vocabulary
    (``tok`` holds ``vocab / tp`` rows) each rank looks up the tokens in
    its range, zeros the rest and the rows are summed over ``tp``."""
    tok = p["tok"]
    if mesh is None or tok.shape[0] * mesh.tp != vocab:
        return tok[tokens]
    n = tok.shape[0]
    local = tokens - mesh.tp_rank * n
    inside = (local >= 0) & (local < n)
    rows = tok[torch.where(inside, local, 0)]
    return mesh.tp_sum(torch.where(inside[..., None], rows, 0))


def lm_logits(p: dict, h: torch.Tensor, mesh=None,
              vocab: int | None = None) -> torch.Tensor:
    """``h @ head`` (``tok.T`` when tied). On a mesh whose ``tp`` splits the
    vocabulary each rank forms its own columns and they are all-gathered
    over ``tp``."""
    w = p["head"] if "head" in p else p["tok"].T
    if mesh is None or w.shape[1] * mesh.tp != vocab:
        return h @ w
    return mesh.tp_cat(mesh.tp_enter(h) @ w, dim=-1)
