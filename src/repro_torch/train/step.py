"""The train step (twin of ``repro/train/step.py``): microbatched gradient
accumulation, optional int8 error-feedback gradient compression, AdamW,
the cosine learning-rate schedule.

The step runs eagerly, differentiated by autograd through
``models.transformer.loss_fn``. Under interp numerics the gradients pass
only through the float glue, as the reference's do: a table read, the
rounding to codes and the int cast have zero derivative, so ``exp_neg``,
``recip_pos``, ``rsqrt_pos`` and the interp softmax pass none, RMSNorm's
reaches x and gamma with the table's rsqrt held constant, and an
activation passes gradient 1 on its linear right tail only. The table
reads on the card go through ``library_eval`` (``library_walk`` for a
segmented library) in the forward pass. A fused backend's kernels
(``act_lib``, ``rmsnorm_lib``, ``softmax_lib``, ``flash_attn_lib``) have no
backward in either package: for CUDA parameters the step refuses them with
a ``ValueError`` before any launch (on the CPU their plain versions are
torch ops and differentiate).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.layers import pdtype
from repro_torch.numerics.ops import get_numerics
from repro_torch.optim.adamw import (AdamWState, adamw_init,
                                     adamw_state_shapes, adamw_update)
from repro_torch.optim.compress import (compress_grads, compress_init,
                                        compress_state_shapes,
                                        decompress_grads)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.util.tree import (leaves_with_paths, tree_leaves,
                                   unflatten_like)

_F32 = torch.float32


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    residual: dict | None  # error-feedback residual (compression on)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    compress_pods: bool = False  # int8 error-feedback compression


def train_state_init(cfg, step_cfg: StepConfig | None = None, seed: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    """``tf.init_params(cfg, seed, device)``, a fresh AdamW state and, with
    compression on, a zero residual."""
    params = tf.init_params(cfg, seed, device)
    res = (compress_init(params) if step_cfg and step_cfg.compress_pods
           else None)
    return TrainState(params, adamw_init(params), res)


def train_state_shapes(cfg, step_cfg: StepConfig) -> TrainState:
    """The state's :class:`~repro_torch.models.layers.Spec` tree."""
    ps = tf.model_shapes(cfg)
    res = compress_state_shapes(ps) if step_cfg.compress_pods else None
    return TrainState(ps, adamw_state_shapes(ps), res)


def _fused_sites(numerics) -> list[str]:
    """The fused (backward-less) backends among ``numerics``'s layers and
    its ``rest``."""
    plan = getattr(numerics, "plan", None)
    if plan is not None:
        return sorted({f"{where}/{site}" for where, site, a
                       in plan.assignments() if a.backend == "interp-fused"})
    return ["all"] if getattr(numerics, "fused", False) else []


def refuse_fused_on_cuda(numerics, params: dict) -> None:
    """``ValueError`` where a fused backend would run on CUDA parameters:
    its kernels return tensors with no autograd history, so the
    parameters upstream of them would silently get no gradient."""
    sites = _fused_sites(numerics)
    if sites and any(t.is_cuda for t in tree_leaves(params)):
        raise ValueError(
            f"fused numerics ({', '.join(sites)}) cannot train on CUDA: "
            f"the fused kernels have no backward in either package; train "
            f"under 'interp' (the unfused glue around library_eval) or "
            f"'exact'")


def batch_to(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(params: dict, batch: dict, cfg, numerics,
                   microbatches: int = 1):
    """(loss, aux, grads) of ``tf.loss_fn`` at ``params``. With n > 1
    microbatches the batch's leading axis is cut into n slices, each
    slice's gradients accumulated in float32, and loss, aux and gradients
    divided by n (the reference's ``_split_micro`` scan); with one the
    gradients keep the parameters' dtypes. A parameter that the loss does
    not reach gets a zero gradient."""
    named = leaves_with_paths(params)
    n = microbatches
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not a whole number of {n} "
                         f"microbatches")

    def one(mb):
        leaves = [t.detach().requires_grad_(True) for _, t in named]
        loss, m = tf.loss_fn(unflatten_like(params, leaves), mb, cfg,
                             numerics)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g
              for g, t in zip(gs, leaves)]
        return loss.detach(), m["aux"].detach(), gs

    if n == 1:
        loss, aux, gs = one(batch)
        return loss, aux, unflatten_like(params, gs)
    sz = b // n
    gsum = [torch.zeros(t.shape, dtype=_F32, device=t.device)
            for _, t in named]
    lsum = torch.zeros((), dtype=_F32, device=gsum[0].device)
    asum = torch.zeros((), dtype=_F32, device=gsum[0].device)
    for i in range(n):
        loss, aux, gs = one({k: v[i * sz:(i + 1) * sz]
                             for k, v in batch.items()})
        for acc, g in zip(gsum, gs):
            acc.add_(g.to(_F32))
        del gs
        lsum, asum = lsum + loss, asum + aux
    return (lsum / n, asum / n,
            unflatten_like(params, [g / n for g in gsum]))


def make_train_step(cfg, step_cfg: StepConfig, library=None,
                    donate: bool = False) -> Callable:
    """Returns ``step(state, batch, step_idx) -> (state, metrics)``:
    ``batch`` numpy arrays or tensors (moved to the parameters' device),
    ``metrics`` 0-dim tensors ``loss``, ``aux``, ``lr``, ``grad_norm``.

    ``library`` binds the interp numerics to a compiled ``InterpLibrary``
    (for a config with a plan: a dict keyed by slot, or None), through the
    same ``get_numerics(cfg, library)`` as the reference, whose interp
    backend is the unfused glue. ``donate=True`` updates the state's
    optimizer tensors in place (the reference's donated state: the values
    are the same); the state handed in must not be read again."""
    numerics = get_numerics(cfg, library)
    pdt = pdtype(cfg)

    def step(state: TrainState, batch: dict, step_idx):
        refuse_fused_on_cuda(numerics, state.params)
        dev = tree_leaves(state.params)[0].device
        batch = batch_to(batch, dev)
        loss, aux, grads = loss_and_grads(state.params, batch, cfg, numerics,
                                          step_cfg.microbatches)
        residual = state.residual
        if step_cfg.compress_pods and residual is not None:
            payload, scales, residual = compress_grads(grads, residual)
            grads = decompress_grads(payload, scales)
        lr = cosine_schedule(int(step_idx), peak_lr=step_cfg.peak_lr,
                             warmup=step_cfg.warmup,
                             total=step_cfg.total_steps)
        params, opt, om = adamw_update(
            grads, state.opt, lr.to(dev), clip_norm=step_cfg.clip_norm,
            weight_decay=step_cfg.weight_decay, param_dtype=pdt,
            donate=donate)
        metrics = {"loss": loss, "aux": aux, "lr": lr,
                   "grad_norm": om["grad_norm"]}
        return TrainState(params, opt, residual), metrics

    return step


def make_eval_step(cfg, library=None) -> Callable:
    """``eval_step(params, batch) -> {"loss", "ce", "aux"}`` without
    gradients (any backend, fused ones included)."""
    numerics = get_numerics(cfg, library)

    def eval_step(params: dict, batch: dict) -> dict:
        dev = tree_leaves(params)[0].device
        with torch.no_grad():
            loss, m = tf.loss_fn(params, batch_to(batch, dev), cfg, numerics)
        return {"loss": loss, **m}

    return eval_step
