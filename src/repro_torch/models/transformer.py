"""Model assembly (twin of ``repro/models/transformer.py``): GQA (QKV bias,
sliding windows), MLA or Mamba2 (SSD) mixers, dense or MoE FFNs, the Jamba
hybrid, the encoder-decoder (Whisper: an encoder over stub frame
embeddings, cross attention in every decoder layer, LayerNorm, learned
positions) and the VLM frontend (InternVL: stub patch embeddings through
an MLP projector in place of the first prompt rows).

``layer_plan`` groups the layers into segments of one layer kind, as the
reference does: one segment of dense-MLP layers for the dense family and
for the decoders of the encoder-decoder and VLM families; a dense layer
0 (``first_dense_ff``) and then the MoE layers for DeepSeekMoE; one
segment of FFN-less SSM layers for Mamba2; for the hybrid one segment
whose step is the ``attn_period``-layer period (attention at the middle
layer, MoE on every ``moe.every``-th). Parameters keep the reference's
tree: ``embed/{tok,head}``, ``segments/seg<i>/<j>/{norm1,mixer,norm2,ffn}``
(no ``norm2`` / ``ffn`` where the layer has no FFN; ``norm_x`` and
``cross`` besides in an encoder-decoder) with every leaf
stacked over a leading layer axis when the segment repeats (unstacked for
a one-step segment), ``final_norm``, and where the config has them the
learned positions ``pos`` (``max_pos`` rows), ``encoder/{pos, layers,
final_norm}`` (layers always stacked) and ``projector``; each leaf has its
own dtype (the
router and the SSM's ``a_log`` / ``dt_bias`` / ``d_skip`` are float32
whatever the parameter dtype).

The cache is the port's own layout, where the reference keeps one cache
per segment. A config without SSM layers has one
:class:`~repro_torch.models.attention.KVCache` with k/v of shape (L, B,
KVH, S, D) and pos of shape (L, B, S) over all L layers (MLA: k (L, B, S,
kv_lora), v (L, B, S, rope); a windowed cache holds
``attention.cache_rows`` rows). A config with SSM layers has a
:class:`MixedCache`: the KVCache stacked over its attention layers only
(``None`` for Mamba2) and an :class:`~repro_torch.models.ssm.SSMState`
stacked over its SSM layers; ``layer_slots`` gives each layer's index in
its own stack. The batch axis is axis 1 of every leaf. Layers run as a
Python loop; decode updates the cache in place. Under a per-layer numerics
plan (``numerics.for_layer``) each layer takes its own numerics and the
final norm the plan's ``rest``; the loop needs no grouping of equal layers
(the reference's ``apply_segment`` groups them to scan each run once).

The encoder-decoder's decoder takes the encoder's output as ``cross=``
(:func:`encoder_forward` computes it once per prompt) in :func:`prefill`
and every :func:`decode_step`; each layer projects its cross K / V from
it on every call, as the reference does. The reference's ``prefill``
takes the frames and returns ``cross`` as a third value; this one returns
(logits, cache) for every family.

Training: ``backbone(..., "train")`` runs ``gqa_train`` / ``mla_train`` /
``ssm_train`` and returns (h, the MoE load-balance aux summed over the
layers); under ``cfg.remat`` each layer is checkpointed
(``torch.utils.checkpoint``, non-reentrant): ``"full"`` recomputes the whole
layer in the backward pass, ``"block"`` saves the matmul outputs (``mm`` /
``addmm``: the reference's ``dots_with_no_batch_dims_saveable``) and
recomputes the rest. :func:`loss_fn` is the mean token cross entropy
(:func:`chunked_ce_loss`, ``LOSS_CHUNK`` positions at a time, each chunk
recomputed in the backward pass so no (B, S, V) float32 buffer forms) plus
``AUX_WEIGHT`` times the aux; it computes an encoder-decoder's encoder
output from ``batch["enc_frames"]`` itself, as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_shapes,
                                       embed_tokens, init_tree, layer_norm,
                                       lm_logits, map_tree, mlp_shapes,
                                       norm_shapes, pdtype, spec, stack_specs)
from repro_torch.models.layers import init_rule  # noqa: F401  (re-export)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.moe import (load_balance_loss_from_probs, moe_block,
                                    moe_shapes)

LOSS_CHUNK = 512
AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str  # attn | mla | ssm
    ffn: str | None  # mlp | moe | None
    mlp_ff: int = 0  # dense MLP hidden size when ffn == "mlp"


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: tuple[LayerKind, ...]  # sub-layers of one stacked step
    repeat: int  # stack length


def layer_plan(cfg) -> list[Segment]:
    if cfg.family == "ssm":
        return [Segment((LayerKind("ssm", None),), cfg.n_layers)]
    if cfg.family == "hybrid":
        period = cfg.attn_period
        if period <= 0 or cfg.n_layers % period:
            raise ValueError(f"hybrid config {cfg.name}: n_layers "
                             f"{cfg.n_layers} is not a whole number of "
                             f"{period}-layer periods")
        pattern = tuple(
            LayerKind("attn" if i == period // 2 else "ssm",
                      "moe" if (cfg.moe and i % cfg.moe.every == 1)
                      else "mlp", cfg.d_ff)
            for i in range(period))
        return [Segment(pattern, cfg.n_layers // period)]
    mixer = "mla" if cfg.mla is not None else "attn"
    if cfg.family == "moe":
        segs, n = [], cfg.n_layers
        if cfg.first_dense_ff:
            segs.append(Segment((LayerKind(mixer, "mlp",
                                           cfg.first_dense_ff),), 1))
            n -= 1
        segs.append(Segment((LayerKind(mixer, "moe"),), n))
        return segs
    if cfg.family in ("dense", "vlm", "encdec"):  # the last two: decoders
        return [Segment((LayerKind(mixer, "mlp", cfg.d_ff),), cfg.n_layers)]
    raise NotImplementedError(f"model family {cfg.family!r} is not ported")


def block_shapes(kind: LayerKind, cfg, cross: bool = False) -> dict:
    mixer = (ssm_mod.ssm_shapes(cfg) if kind.mixer == "ssm"
             else attn.mla_shapes(cfg) if kind.mixer == "mla"
             else attn.gqa_shapes(cfg))
    out = {"norm1": norm_shapes(cfg), "mixer": mixer}
    if cross:
        out["norm_x"] = norm_shapes(cfg)
        out["cross"] = attn.cross_shapes(cfg)
    if kind.ffn is not None:
        out["norm2"] = norm_shapes(cfg)
        out["ffn"] = (moe_shapes(cfg) if kind.ffn == "moe"
                      else mlp_shapes(cfg, kind.mlp_ff))
    return out


def segment_shapes(seg: Segment, cfg, cross: bool = False) -> dict:
    inner = {str(i): block_shapes(k, cfg, cross)
             for i, k in enumerate(seg.pattern)}
    return stack_specs(inner, seg.repeat) if seg.repeat > 1 else inner


def encoder_shapes(cfg) -> dict:
    """The encoder's tree: its own learned positions (``source_len``
    rows), ``n_layers`` GQA + MLP layers stacked (even one), the final
    norm."""
    layer = {"norm1": norm_shapes(cfg), "mixer": attn.gqa_shapes(cfg),
             "norm2": norm_shapes(cfg), "ffn": mlp_shapes(cfg, cfg.d_ff)}
    return {"pos": spec((cfg.encoder.source_len, cfg.d_model), pdtype(cfg)),
            "layers": stack_specs(layer, cfg.encoder.n_layers),
            "final_norm": norm_shapes(cfg)}


def param_shapes(cfg) -> dict:
    """The reference's ``model_shapes``: a tree of
    :class:`~repro_torch.models.layers.Spec` leaves."""
    dt = pdtype(cfg)
    cross = cfg.family == "encdec"
    out = {"embed": embed_shapes(cfg),
           "segments": {f"seg{i}": segment_shapes(seg, cfg, cross)
                        for i, seg in enumerate(layer_plan(cfg))},
           "final_norm": norm_shapes(cfg)}
    if cfg.learned_pos:
        out["pos"] = spec((cfg.max_pos, cfg.d_model), dt)
    if cfg.encoder is not None:
        out["encoder"] = encoder_shapes(cfg)
    if cfg.frontend == "vision_stub":
        f, d = cfg.frontend_dim, cfg.d_model
        out["projector"] = {
            "norm": {"scale": spec((f,), dt), "bias": spec((f,), dt)},
            "w1": spec((f, d), dt), "b1": spec((d,), dt),
            "w2": spec((d, d), dt), "b2": spec((d,), dt)}
    return out


def model_shapes(cfg) -> dict:
    """The reference's name for :func:`param_shapes`."""
    return param_shapes(cfg)


def init_params(cfg, seed: int = 0, device: str | torch.device = "cuda"
                ) -> dict:
    """Random parameters of ``cfg``: :func:`~repro_torch.models.layers.
    init_tree` of :func:`param_shapes` (the reference's ``init_tree``
    rules, :func:`~repro_torch.models.layers.init_rule`)."""
    return init_tree(param_shapes(cfg), seed, device)


@functools.lru_cache(maxsize=None)
def layer_slots(cfg) -> tuple:
    """Per global layer index: (segment name, pattern key, index in the
    segment's stack or None for an unstacked segment, index in its cache
    stack, LayerKind). The cache stack is the whole layer stack for a
    config without SSM layers; with them, SSM layers index the
    :class:`MixedCache`'s ``ssm`` stack and attention layers its ``kv``
    stack, each in layer order."""
    out, seen = [], {}
    ssm = has_ssm(cfg)
    for s, seg in enumerate(layer_plan(cfg)):
        for r in range(seg.repeat):
            for j, kind in enumerate(seg.pattern):
                key = kind.mixer == "ssm" if ssm else None
                ci = seen[key] = seen.get(key, -1) + 1
                out.append((f"seg{s}", str(j),
                            r if seg.repeat > 1 else None, ci, kind))
    return tuple(out)


def has_ssm(cfg) -> bool:
    """Whether any layer of ``cfg`` has the SSM mixer."""
    return any(k.mixer == "ssm" for seg in layer_plan(cfg)
               for k in seg.pattern)


def layer_params(p: dict, cfg, i: int):
    """Layer ``i``'s kind and parameters (views into its segment's
    stack)."""
    seg, j, r, _, kind = layer_slots(cfg)[i]
    tree = p["segments"][seg][j]
    return kind, (tree if r is None else map_tree(lambda _n, t: t[r], tree))


class MixedCache(NamedTuple):
    """The cache of a config with SSM layers: the attention layers' K/V
    stacked over those layers (None where there are none: Mamba2) and the
    SSM layers' state stacked over those; batch axis 1 on every leaf."""

    kv: attn.KVCache | None
    ssm: ssm_mod.SSMState


def cache_leaves(caches) -> tuple:
    """Every tensor of a cache of either form, in a fixed order (k, v, pos,
    then conv, ssm)."""
    if isinstance(caches, MixedCache):
        return (*(caches.kv or ()), *caches.ssm)
    return tuple(caches)


def _map_cache(fn, caches):
    """The same form of cache with ``fn`` applied to every leaf."""
    if isinstance(caches, MixedCache):
        kv = None if caches.kv is None else attn.KVCache(*map(fn, caches.kv))
        return MixedCache(kv, ssm_mod.SSMState(*map(fn, caches.ssm)))
    return attn.KVCache(*map(fn, caches))


def _kv(caches) -> attn.KVCache | None:
    return caches.kv if isinstance(caches, MixedCache) else caches


def kv_rows(caches) -> int | None:
    """The key rows of each slot's attention cache (a windowed ring's
    ``s_eff``), or None for a cache without attention layers."""
    kv = _kv(caches)
    return None if kv is None else kv.pos.shape[-1]


def cache_specs(cfg, b: int, cache_len: int) -> attn.KVCache:
    """One attention layer's cache leaves (every attention layer of a
    ported family has the same mixer): ``gqa_cache_specs`` (a windowed
    ring of ``attention.cache_rows`` rows) or ``mla_cache_specs``."""
    fn = (attn.mla_cache_specs if cfg.mla is not None
          else attn.gqa_cache_specs)
    return fn(cfg, b, cache_len, pdtype(cfg))


def init_cache(cfg, b: int, cache_len: int,
               device: str | torch.device = "cuda"):
    """The empty stacked cache: zeros, positions -1, a layer axis first; a
    :class:`MixedCache` for a config with SSM layers."""
    dev = resolve(device)

    def stack(specs, n: int) -> list:
        return [torch.full((n, *sp.shape), -1 if sp.dtype == torch.int32
                           else 0, dtype=sp.dtype, device=dev)
                for sp in specs]

    if not has_ssm(cfg):
        return attn.KVCache(*stack(cache_specs(cfg, b, cache_len),
                                   cfg.n_layers))
    n_ssm = sum(slot[-1].mixer == "ssm" for slot in layer_slots(cfg))
    n_kv = cfg.n_layers - n_ssm
    kv = (attn.KVCache(*stack(cache_specs(cfg, b, cache_len), n_kv))
          if n_kv else None)
    return MixedCache(kv, ssm_mod.SSMState(*stack(
        ssm_mod.ssm_state_specs(cfg, b, pdtype(cfg)), n_ssm)))


def splice_cache(cfg, pool, one, slot: int):
    """Write one request's prefilled cache (batch size 1) into ``slot`` of
    the pool along the *batch* axis (axis 1: axis 0 is the layer stack),
    in place, leaf by leaf."""
    for dst, src in zip(cache_leaves(pool), cache_leaves(one)):
        dst[:, slot] = src[:, 0].to(dst.dtype)
    return pool


def apply_layer(lp: dict, kind: LayerKind, h, positions, cfg, numerics,
                mode: str, cache=None, cache_len: int = 0, pos=None,
                cross=None):
    """One layer (the reference's ``apply_block``): norm, mixer, residual;
    with ``cross`` (the encoder output) norm, cross attention, residual;
    then norm, FFN, residual where the layer has an FFN. Returns (h, x):
    in "prefill" x is the layer's new cache (a KVCache or an SSMState), in
    "decode" ``cache``, one layer's view of the pool, updated in place; in
    "train" the layer's MoE load-balance aux (None without an MoE FFN)."""
    x = apply_norm(lp["norm1"], h, cfg, numerics)
    if kind.mixer == "ssm":
        if mode == "train":
            y = ssm_mod.ssm_train(lp["mixer"], x, cfg, numerics)
        elif mode == "prefill":
            y, cache = ssm_mod.ssm_prefill(lp["mixer"], x, cfg, numerics)
        else:
            y, cache = ssm_mod.ssm_decode(lp["mixer"], x, cache, cfg,
                                          numerics)
    else:
        mla = kind.mixer == "mla"
        if mode == "train":
            y = (attn.mla_train if mla else attn.gqa_train)(
                lp["mixer"], x, positions, cfg, numerics)
        elif mode == "prefill":
            y, cache = (attn.mla_prefill if mla else attn.gqa_prefill)(
                lp["mixer"], x, positions, cfg, numerics, cache_len)
        else:
            y, cache = (attn.mla_decode if mla else attn.gqa_decode)(
                lp["mixer"], x, pos, cache, cfg, numerics)
    h = h + y
    if cross is not None:
        xc = apply_norm(lp["norm_x"], h, cfg, numerics)
        kv = attn.cross_kv(lp["cross"], cross, cfg)
        h = h + attn.cross_apply(lp["cross"], xc, kv, cfg, numerics)
    aux = None
    if kind.ffn is not None:
        x2 = apply_norm(lp["norm2"], h, cfg, numerics)
        if kind.ffn == "moe":
            y2, probs = moe_block(lp["ffn"], x2, cfg, numerics,
                                  return_probs=True)
            if mode == "train":
                aux = load_balance_loss_from_probs(probs, cfg)
        else:
            y2 = apply_mlp(lp["ffn"], x2, cfg, numerics)
        h = h + y2
    return h, (aux if mode == "train" else cache)


# ops whose outputs "block" remat keeps: products without a batch axis
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(_ctx, op, *_args, **_kw):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``fn`` under ``cfg.remat``: as it is ("none"), or checkpointed,
    non-reentrant, recomputing everything ("full") or all but the matmul
    outputs ("block") in the backward pass."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "block":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_matmuls))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def backbone(p: dict, h, positions, cfg, numerics, mode: str,
             caches=None, cache_len: int = 0, pos=None, cross=None):
    """Run every layer and the final norm. ``mode``: "prefill" (returns
    (h, the new stacked cache)), "decode" (updates ``caches`` in place;
    returns (h, caches)) or "train" (returns (h, the MoE aux summed over
    the layers), each layer under ``cfg.remat``); ``cross`` is the encoder
    output every layer's cross attention reads. ``numerics`` is one
    backend for every layer, or a plan-resolved object whose
    ``for_layer(i)`` gives layer ``i``'s (the final norm then runs under
    the object itself: the plan's ``rest``)."""
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    per_layer = hasattr(numerics, "for_layer")
    slots = layer_slots(cfg)
    new_kv, new_ssm = [], []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        num = numerics.for_layer(i) if per_layer else numerics
        kind, lp = layer_params(p, cfg, i)
        ssm = kind.mixer == "ssm"
        if mode == "train":
            def layer(h_in, lp=lp, kind=kind, num=num):
                return apply_layer(lp, kind, h_in, positions, cfg, num,
                                   "train", cross=cross)
            h, a = _remat(layer, cfg)(h)
            if a is not None:
                aux = aux + a
            continue
        layer = None
        if mode == "decode":
            ci = slots[i][3]
            layer = (ssm_mod.SSMState(*(t[ci] for t in caches.ssm)) if ssm
                     else attn.KVCache(*(t[ci] for t in _kv(caches))))
        h, c = apply_layer(lp, kind, h, positions, cfg, num, mode, layer,
                           cache_len, pos, cross)
        if mode == "prefill":
            (new_ssm if ssm else new_kv).append(c)
    h = apply_norm(p["final_norm"], h, cfg, numerics)
    if mode == "train":
        return h, aux
    if mode == "prefill":
        kv = (attn.KVCache(*(torch.stack(t) for t in zip(*new_kv)))
              if new_kv else None)
        caches = (MixedCache(kv, ssm_mod.SSMState(
            *(torch.stack(t) for t in zip(*new_ssm)))) if new_ssm else kv)
    return h, caches


def encoder_forward(p: dict, frames: torch.Tensor, cfg,
                    numerics) -> torch.Tensor:
    """The encoder over stub frame embeddings: ``p`` is the tree's
    ``encoder`` subtree, frames (B, S_src, d) (float32 from the stub, cast
    to the parameter dtype) plus the first S_src learned positions, then
    non-causal GQA + MLP layers and the final norm. Returns the encoder
    output (B, S_src, d) that :func:`prefill` and :func:`decode_step` take
    as ``cross``."""
    b, s, _ = frames.shape
    h = frames.to(pdtype(cfg))
    h = h + p["pos"][:s].to(h.dtype)
    positions = torch.arange(s, dtype=torch.int32,
                             device=frames.device).expand(b, s)
    for i in range(cfg.encoder.n_layers):
        lp = map_tree(lambda _n, t: t[i], p["layers"])
        x = apply_norm(lp["norm1"], h, cfg, numerics)
        h = h + attn.gqa_train(lp["mixer"], x, positions, cfg, numerics,
                               causal=False)
        x2 = apply_norm(lp["norm2"], h, cfg, numerics)
        h = h + apply_mlp(lp["ffn"], x2, cfg, numerics)
    return apply_norm(p["final_norm"], h, cfg, numerics)


def _project_frontend(p: dict, emb: torch.Tensor, cfg,
                      numerics) -> torch.Tensor:
    """The InternVL MLP projector: stub patch embeddings (B, n,
    frontend_dim) -> (B, n, d) in emb's dtype. A float32 LayerNorm, then
    ``numerics.gelu(x @ w1 + b1) @ w2 + b2``, each product in the promoted
    dtype of its operands, as the reference's ``jnp`` promotes them
    (float32 patches against bf16 weights: float32)."""
    pr = p["projector"]
    x = layer_norm(emb, pr["norm"]["scale"], pr["norm"]["bias"])
    dt = torch.promote_types(x.dtype, pr["w1"].dtype)
    h = numerics.gelu(x.to(dt) @ pr["w1"].to(dt) + pr["b1"].to(dt))
    return (h @ pr["w2"].to(dt) + pr["b2"].to(dt)).to(emb.dtype)


def _embed_inputs(p: dict, tokens, positions, cfg, numerics,
                  frontend_emb=None) -> torch.Tensor:
    """Token embeddings; under the vision stub the projected patches in
    place of the first n rows; under ``learned_pos`` plus the positions'
    rows of ``pos`` (clamped to the table, as the reference's gather
    clamps)."""
    h = embed_tokens(p["embed"], tokens)
    if frontend_emb is not None and cfg.frontend == "vision_stub":
        patches = _project_frontend(p, frontend_emb, cfg, numerics)
        n = patches.shape[1]
        h = torch.cat([patches.to(h.dtype), h[:, n:]], 1)
    if cfg.learned_pos:
        idx = torch.clamp(positions, max=cfg.max_pos - 1).to(torch.int64)
        h = h + p["pos"][idx].to(h.dtype)
    return h


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward(p: dict, tokens: torch.Tensor, cfg, numerics, frontend_emb=None,
            enc_frames=None) -> torch.Tensor:
    """The training-shaped forward -> logits (B, S, V). An
    encoder-decoder runs its encoder over ``enc_frames`` where they are
    given (else the decoder skips cross attention, as the reference's
    does). For a large vocabulary take :func:`loss_fn` instead, whose
    chunked CE never forms (B, S, V)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    cross = (encoder_forward(p["encoder"], enc_frames, cfg, numerics)
             if enc_frames is not None else None)
    h = _embed_inputs(p, tokens, positions, cfg, numerics, frontend_emb)
    h, _ = backbone(p, h, positions, cfg, numerics, "train", cross=cross)
    return lm_logits(p["embed"], h)


def _ce_chunk(p_embed: dict, hc, lc, mc) -> torch.Tensor:
    """Masked CE summed over one (B, chunk) slice; logits in float32."""
    logits = lm_logits(p_embed, hc).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].to(torch.int64))[..., 0]
    return torch.sum((lse - gold) * mc)


def chunked_ce_loss(p_embed: dict, h: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over the masked tokens. The logits form ``LOSS_CHUNK``
    sequence positions at a time (the sequence padded with mask 0 to whole
    chunks), each chunk checkpointed: its (B, chunk, V) float32 logits are
    recomputed in the backward pass, never kept."""
    b, s, _ = h.shape
    chunk = min(LOSS_CHUNK, s)
    pad = (-s) % chunk
    mask = mask.to(torch.float32)
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(h.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_ce_chunk, p_embed, h[:, sl],
                                   labels[:, sl], mask[:, sl],
                                   use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def loss_fn(p: dict, batch: dict, cfg, numerics):
    """batch: tokens (B, S) int, labels (B, S) int, mask (B, S), plus
    ``frontend_emb`` (VLM) or ``enc_frames`` (encoder-decoder), tensors on
    the parameters' device. Returns (CE + ``AUX_WEIGHT`` * aux, {"ce",
    "aux"})."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    cross = (encoder_forward(p["encoder"], batch["enc_frames"], cfg,
                             numerics) if cfg.encoder is not None else None)
    h = _embed_inputs(p, tokens, positions, cfg, numerics,
                      batch.get("frontend_emb"))
    h, aux = backbone(p, h, positions, cfg, numerics, "train", cross=cross)
    ce = chunked_ce_loss(p["embed"], h, batch["labels"], batch["mask"])
    return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}


def _check_inputs(cfg, cross, lengths: dict, frontend_emb=None) -> None:
    """The inputs the reference fails on, refused before any launch:
    ``cross`` missing for an encoder-decoder or given to a config without
    an encoder; under ``learned_pos`` a prompt or cache longer than the
    ``max_pos``-row table (the reference's gather clamps; a CUDA gather
    past it is a device-side assert); patches for more rows than the
    prompt has."""
    if cfg.encoder is not None and cross is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass cross= "
                         f"the encoder output (encoder_forward)")
    if cfg.encoder is None and cross is not None:
        raise ValueError(f"{cfg.name} has no encoder: cross= must be None")
    if cfg.learned_pos:
        for what, n in lengths.items():
            if n > cfg.max_pos:
                raise ValueError(f"{what} {n} exceeds the {cfg.max_pos} "
                                 f"learned positions of {cfg.name}")
    if frontend_emb is not None and cfg.frontend == "vision_stub":
        n, s = frontend_emb.shape[1], lengths["prompt length"]
        if n > s:
            raise ValueError(f"{n} patch embeddings for a {s}-token prompt: "
                             f"the patches take the prompt's first rows")


def prefill(p: dict, tokens: torch.Tensor, cfg, numerics, cache_len: int,
            frontend_emb=None, cross=None):
    """Process the prompt; returns (last-position logits (B, 1, V), cache).
    ``frontend_emb`` (B, n, frontend_dim): the vision stub's patches, which
    take the first n <= S prompt rows; ``cross``: the encoder output
    (:func:`encoder_forward`), which an encoder-decoder needs and any other
    config refuses."""
    b, s = tokens.shape
    _check_inputs(cfg, cross, {"prompt length": s, "cache_len": cache_len},
                  frontend_emb)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    h = _embed_inputs(p, tokens, positions, cfg, numerics, frontend_emb)
    h, caches = backbone(p, h, positions, cfg, numerics, "prefill",
                         cache_len=cache_len, cross=cross)
    return lm_logits(p["embed"], h[:, -1:]), caches


def mask_cache_tail(caches, true_lens) -> attn.KVCache:
    """Mark every cache row at or past each batch row's true length as
    empty (``pos = -1``, the ``init_cache`` sentinel the attention mask
    treats as dead).

    A padded (bucketed) prefill writes the pad suffix's K/V rows with live
    positions; a later decode step would attend to them. The K/V rows
    themselves stay: with ``pos`` at -1 the mask drops them, and decode
    overwrites row ``p`` when the sequence reaches position ``p``. The
    (B, S) validity mask broadcasts over the leading layer axis. SSM state
    is not positional and cannot be masked: a :class:`MixedCache` is
    refused."""
    if isinstance(caches, MixedCache):
        raise ValueError("mask_cache_tail: SSM state is cumulative, a pad "
                         "suffix cannot be masked out of it")
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
    if has_ssm(cfg):
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


def extract_cache_row(cfg, pool, i):
    """Batch row ``i`` of a pooled cache of either form, keeping the batch
    axis (axis 1: axis 0 is the layer stack): the inverse of
    :func:`splice_cache`. ``i`` may be a device index tensor."""
    if isinstance(i, torch.Tensor):
        idx = i.reshape(1).to(torch.int64)
        return _map_cache(lambda t: t.index_select(1, idx), pool)
    return _map_cache(lambda t: t[:, i:i + 1], pool)


def splice_cache_rows(cfg, pool, rows, slots: torch.Tensor):
    """Write the P batch rows of ``rows`` into pool slots ``slots`` (a (P,)
    device index tensor of distinct slots) in place: P of
    :func:`splice_cache` of :func:`extract_cache_row` in one op per leaf,
    with the slots read on the device (what a CUDA graph replays for any
    slot assignment)."""
    idx = slots.to(torch.int64)
    for dst, src in zip(cache_leaves(pool), cache_leaves(rows)):
        dst.index_copy_(1, idx, src.to(dst.dtype))
    return pool


def decode_step(p: dict, token: torch.Tensor, pos, caches, cfg, numerics,
                cross=None):
    """token: (B, 1) int; pos: scalar or (B,) per-slot positions; ``cross``
    the encoder output of an encoder-decoder (as in :func:`prefill`).
    Returns (logits (B, 1, V), caches updated in place)."""
    b = token.shape[0]
    _check_inputs(cfg, cross, {"cache_len": kv_rows(caches) or 0})
    pos, positions = attn._decode_positions(pos, b, token.device)
    h = _embed_inputs(p, token, positions, cfg, numerics)
    h, caches = backbone(p, h, None, cfg, numerics, "decode", caches=caches,
                         pos=pos, cross=cross)
    return lm_logits(p["embed"], h), caches
