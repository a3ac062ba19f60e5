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

``mesh=`` (``launch.mesh.make_host_mesh``: ``data x model``, one process
per rank; or a traced production mesh, ``pod x data x model``): the
state holds this rank's shards (:func:`shard_state`,
``launch.sharding.TRAIN_PARAM_RULES``, the reference's ``PARAM_RULES``:
Megatron column / row over ``model``, ZeRO-3 over ``fsdp``, i.e. ``pod x
data`` or ``data``), the parameters, the AdamW master and moments and the
compression residual alike. The batch is this rank's rows. The step
all-gathers each layer's ZeRO-3 leaves over their ``fsdp`` axes inside
the layer's checkpointed function (so remat gathers them again in the
backward pass rather than keeping them) and the backward pass
reduce-scatters their gradients over the same axes; the models issue the
``model`` collectives through autograd (``Mesh.tp_*``). Each gradient is
then summed over the data-parallel axes (``pod``, ``data``) it is not
split over, in one all-reduce per axis and group of leaves, and divided
by the data-parallel size, as are loss and aux. ``grad_norm`` sums each
leaf's squares over the axes it is split over. AdamW updates this rank's
shard. Under ``compress_pods`` each gradient shard takes the int8
error-feedback round trip with its whole leaf's scale (the amax reduced
over the leaf's shards), so the sharded step is the unsharded one; as in
the reference, the reduction itself carries the dequantized floats.
"""
from __future__ import annotations

import dataclasses
import math
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
                   microbatches: int = 1, mesh=None, gather=None):
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
                             numerics, mesh, gather)
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


def train_specs(cfg, mesh) -> dict:
    """The parameters' placement specs on a training mesh (from the full
    shapes): ``TRAIN_PARAM_RULES``, a mixer whose heads ``model`` does not
    divide replicated over it (``launch.sharding.whole_mixer``)."""
    from repro_torch.launch import sharding as shlib

    return shlib.placement_specs(tf.model_shapes(cfg), cfg, mesh,
                                 shlib.TRAIN_PARAM_RULES)


def shard_state(state: TrainState, cfg, mesh) -> TrainState:
    """This rank's shard of a full train state: parameters, the AdamW
    master and moments and the compression residual by
    :func:`train_specs`; the step replicated."""
    from repro_torch.launch import sharding as shlib

    specs = train_specs(cfg, mesh)
    split = shlib.split_leaves(state.params, cfg, mesh)

    def cut(tree):
        return (None if tree is None
                else shlib.shard_tree(tree, specs, mesh, split))
    return TrainState(cut(state.params),
                      AdamWState(state.opt.step, *(cut(t) for t in (
                          state.opt.master, state.opt.mu, state.opt.nu))),
                      cut(state.residual))


def gather_state(state: TrainState, cfg, mesh) -> TrainState:
    """The full train state from every rank's shard (the inverse of
    :func:`shard_state`; a collective over every axis a leaf is split
    over)."""
    from repro_torch.launch import sharding as shlib

    specs = train_specs(cfg, mesh)
    split = shlib.split_leaves(tf.model_shapes(cfg), cfg, mesh)

    def whole(tree):
        return (None if tree is None
                else shlib.gather_tree(tree, specs, mesh, split))
    return TrainState(whole(state.params),
                      AdamWState(state.opt.step, *(whole(t) for t in (
                          state.opt.master, state.opt.mu, state.opt.nu))),
                      whole(state.residual))


_DP = ("pod", "data")


class _FSDPGather(torch.autograd.Function):
    """All-gather a ZeRO-3 shard over ``axes`` along ``dim`` (the inner
    axis first, as ``shard_tree`` cuts); the gradient is reduce-scattered
    back over the same axes."""

    @staticmethod
    def forward(ctx, t, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        for ax in reversed(axes):
            t = mesh.all_gather(t, ax, dim)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for ax in ctx.axes:
            g = ctx.mesh.reduce_scatter(g, ax, ctx.dim)
        return g, None, None, None


def fsdp_gather_fn(cfg, specs, mesh):
    """``gather(subtree, path)`` for ``tf.loss_fn``: every leaf of the
    subtree at ``path`` whole over its ``fsdp`` axes (:class:`_FSDPGather`);
    a layer's slice of a stacked leaf takes the stacked spec without its
    layer axis. None where no leaf is split over a data-parallel axis."""
    from repro_torch.launch.sharding import axes_of, spec_leaves

    by_path = dict(zip((p for p, _ in leaves_with_paths(
        tf.model_shapes(cfg))), spec_leaves(specs)))
    if not any(ax in _DP for sp in by_path.values() for e in sp
               for ax in axes_of(e)):
        return None

    def gather(tree, prefix: str):
        out = []
        for path, t in leaves_with_paths(tree):
            spec = by_path[f"{prefix}/{path}" if path else prefix]
            spec = spec[len(spec) - t.dim():]
            for dim, e in enumerate(spec):
                axes = tuple(ax for ax in axes_of(e) if ax in _DP)
                if axes:
                    t = _FSDPGather.apply(t, mesh, dim, axes)
            out.append(t)
        return unflatten_like(tree, out)
    return gather


def _split_axes(specs) -> list:
    """Per leaf (flattening order) the sorted mesh axes it is split over."""
    from repro_torch.launch.sharding import axes_of, spec_leaves

    return [tuple(sorted({ax for e in sp for ax in axes_of(e)}))
            for sp in spec_leaves(specs)]


def _groups(keys: list) -> dict:
    out: dict = {}
    for i, k in enumerate(keys):
        out.setdefault(k, []).append(i)
    return out


def _dp_reduce(mesh, loss, aux, grads: dict, split: list):
    """Loss, aux and gradients summed over the data-parallel axes each is
    not split over (one float32 buffer per group of leaves, one all-reduce
    per axis) and divided by the data-parallel size."""
    dp = [ax for ax in _DP if ax in mesh.shape]
    n = math.prod(mesh.shape[ax] for ax in dp)
    leaves = tree_leaves(grads)
    need = [tuple(ax for ax in dp if ax not in sp) for sp in split]
    full = tuple(dp)
    groups = _groups(need)
    groups.setdefault(full, [])
    out = list(leaves)
    for axes, idx in groups.items():
        extra = ([loss.reshape(1).to(_F32), aux.reshape(1).to(_F32)]
                 if axes == full else [])
        flat = torch.cat(extra + [leaves[i].reshape(-1).to(_F32)
                                  for i in idx])
        for ax in axes:
            mesh.all_reduce(flat, ax)
        flat = flat / n
        at = len(extra)
        if extra:
            loss, aux = flat[0], flat[1]
        for i in idx:
            g = leaves[i]
            out[i] = flat[at:at + g.numel()].view(g.shape).to(g.dtype)
            at += g.numel()
    return loss, aux, unflatten_like(grads, out)


def _reduce_groups(mesh, vals: list, split: list, op: str) -> list:
    """Each of the 0-dim float32 ``vals`` reduced (``op``) over the axes
    its leaf is split over: one all-reduce per axis and group."""
    out = list(vals)
    for axes, idx in _groups(split).items():
        if not axes:
            continue
        flat = torch.stack([vals[i].reshape(()) for i in idx])
        for ax in axes:
            mesh.all_reduce(flat, ax, op)
        for k, i in enumerate(idx):
            out[i] = flat[k]
    return out


def _mesh_grad_norm(grads: dict, split: list, mesh) -> torch.Tensor:
    """The global norm of sharded gradients: each leaf's squares summed
    over the axes it is split over, each replicated leaf counted once."""
    leaves = tree_leaves(grads)
    sq = [torch.sum(g.to(_F32) ** 2) for g in leaves]
    groups = _groups(split)
    total = torch.zeros((), dtype=_F32, device=leaves[0].device)
    for axes in sorted(groups, key=len):
        part = sum((sq[i] for i in groups[axes]), torch.zeros(
            (), dtype=_F32, device=total.device))
        if axes:
            part = part.reshape(1).clone()
            for ax in axes:
                mesh.all_reduce(part, ax)
            part = part[0]
        total = total + part
    return torch.sqrt(total)


def _compress(grads: dict, residual: dict, split: list, mesh):
    """``compress_grads`` on this rank's gradient shards with each whole
    leaf's scale (its amax reduced over the leaf's shards)."""
    if mesh is None:
        return compress_grads(grads, residual)
    amax = [torch.amax(torch.abs(g.to(_F32) + r)) for g, r in
            zip(tree_leaves(grads), tree_leaves(residual))]
    amax = _reduce_groups(mesh, amax, split, "max")
    return compress_grads(grads, residual, amax=amax)


def make_train_step(cfg, step_cfg: StepConfig, library=None,
                    donate: bool = False, mesh=None) -> Callable:
    """Returns ``step(state, batch, step_idx) -> (state, metrics)``:
    ``batch`` numpy arrays or tensors (moved to the parameters' device),
    ``metrics`` 0-dim tensors ``loss``, ``aux``, ``lr``, ``grad_norm``.

    ``library`` binds the interp numerics to a compiled ``InterpLibrary``
    (for a config with a plan: a dict keyed by slot, or None), through the
    same ``get_numerics(cfg, library)`` as the reference, whose interp
    backend is the unfused glue. ``donate=True`` updates the state's
    optimizer tensors in place (the reference's donated state: the values
    are the same); the state handed in must not be read again. ``mesh``:
    the training mesh whose shards the state holds (:func:`shard_state`);
    ``batch`` is then this rank's rows."""
    numerics = get_numerics(cfg, library)
    pdt = pdtype(cfg)
    split = gather = None
    if mesh is not None:
        specs = train_specs(cfg, mesh)
        split = _split_axes(specs)
        gather = fsdp_gather_fn(cfg, specs, mesh)

    def step(state: TrainState, batch: dict, step_idx):
        refuse_fused_on_cuda(numerics, state.params)
        dev = tree_leaves(state.params)[0].device
        if mesh is not None:
            mesh.check_device(dev)
        batch = batch_to(batch, dev)
        loss, aux, grads = loss_and_grads(state.params, batch, cfg, numerics,
                                          step_cfg.microbatches, mesh, gather)
        gnorm = None
        if mesh is not None:
            loss, aux, grads = _dp_reduce(mesh, loss, aux, grads, split)
        residual = state.residual
        if step_cfg.compress_pods and residual is not None:
            payload, scales, residual = _compress(grads, residual, split,
                                                  mesh)
            grads = decompress_grads(payload, scales)
        lr = cosine_schedule(int(step_idx), peak_lr=step_cfg.peak_lr,
                             warmup=step_cfg.warmup,
                             total=step_cfg.total_steps)
        if mesh is not None:
            gnorm = _mesh_grad_norm(grads, split, mesh)
        params, opt, om = adamw_update(
            grads, state.opt, lr.to(dev), clip_norm=step_cfg.clip_norm,
            weight_decay=step_cfg.weight_decay, param_dtype=pdt,
            donate=donate, gnorm=gnorm)
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
