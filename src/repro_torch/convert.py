"""Carry the reference's parameters and train states into the port, and
the port's back out as numpy.

``params_from_jax`` takes the reference's parameter tree as numpy arrays,
i.e. ``jax.tree.map(np.asarray, repro.models.transformer.init_params(key,
cfg))`` (``segments/seg<i>/<j>/...``: stacked over layers where a segment
repeats, unstacked for a one-step segment; Jamba's step is its period of
sub-layers ``0`` .. ``attn_period - 1``; Whisper's ``pos``, ``encoder``
and per-layer ``norm_x`` / ``cross``, LayerNorm ``bias`` leaves,
InternVL's ``projector``), and returns the port's
parameter dict, so that both packages compute the same function. The SSM
mixer's ``a_log``, ``dt_bias`` and ``d_skip`` are float32 in both trees,
its other leaves in the parameter dtype. Every
leaf must have the port's shape and dtype for ``cfg``, or the parameter
dtype: an optimizer step writes every leaf back in it, in both packages
(``adamw_update``), so a trained state's router and SSM leaves are bf16
in a bf16 model. Nothing is cast. A
reference leaf that the port's tree does not name is refused too: a
dropped leaf (a QKV bias, say) would otherwise show only as a logit
difference.

``train_state_from_jax`` takes a reference ``TrainState`` as numpy
(``jax.tree.map(np.asarray, state)``: params, the AdamW ``step`` /
``master`` / ``mu`` / ``nu``, the compression ``residual`` or None) and
returns the port's :class:`~repro_torch.train.step.TrainState`.
``to_numpy`` is the inverse direction for any of the port's trees: the
same structure with numpy leaves, bf16 as numpy's ``bfloat16`` type
(registered by ``ml_dtypes``, which the reference loads). Both packages'
checkpoints carry states too (``repro_torch.checkpoint``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.layers import Spec, map_tree, pdtype
from repro_torch.models.transformer import param_shapes
from repro_torch.util.tree import tree_map


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # owned and writable
    if a.dtype.name == "bfloat16":  # no numpy dtype: move the raw bits
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: dict, cfg, device: str | torch.device = "cuda"
                    ) -> dict:
    return _from_tree(tree, param_shapes(cfg), resolve(device), cfg.name,
                      pdtype(cfg))


def _from_tree(tree: dict, shapes: dict, dev: torch.device,
               arch: str, written: torch.dtype | None = None) -> dict:
    """``tree``'s numpy leaves as tensors on ``dev`` in the structure of
    the :class:`Spec` tree ``shapes``, each checked against its spec: its
    shape, and its dtype or ``written`` (the dtype an optimizer step
    writes every parameter back in)."""

    def walk(shapes: dict, src: dict, path: str) -> dict:
        extra = sorted(set(src) - set(shapes))
        if extra:
            raise KeyError(f"reference leaves {[path + e for e in extra]} "
                           f"have no place in the port's tree for "
                           f"{arch}")
        out = {}
        for name, sp in shapes.items():
            if name not in src:
                raise KeyError(f"reference tree has no {path}{name}")
            if isinstance(sp, dict):
                out[name] = walk(sp, src[name], f"{path}{name}/")
                continue
            t = _tensor(np.asarray(src[name]))
            if tuple(t.shape) != sp.shape:
                raise ValueError(f"{path}{name}: shape {tuple(t.shape)} != "
                                 f"{sp.shape}")
            if t.dtype not in (sp.dtype, written):
                raise TypeError(f"{path}{name}: dtype {t.dtype} != "
                                f"{sp.dtype}")
            out[name] = t.to(dev)
        return out

    return walk(shapes, tree, "")


def train_state_from_jax(state, cfg, device: str | torch.device = "cuda"):
    """The port's ``TrainState`` from the reference's, as numpy; every leaf
    must have the port's shape and dtype (float32 optimizer state, an
    int32 step)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    dev = resolve(device)
    shapes = param_shapes(cfg)
    f32 = map_tree(lambda _n, sp: Spec(sp.shape, torch.float32), shapes)
    opt = state.opt
    step = _tensor(np.asarray(opt.step))
    if step.shape != () or step.dtype != torch.int32:
        raise TypeError(f"opt/step: {step.dtype}{tuple(step.shape)}, want "
                        f"a 0-dim int32")
    res = state.residual
    return TrainState(
        params_from_jax(state.params, cfg, dev),
        AdamWState(step.to(dev), *(_from_tree(t, f32, dev, cfg.name)
                                   for t in (opt.master, opt.mu, opt.nu))),
        None if res is None else _from_tree(res, f32, dev, cfg.name))


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError as e:
        raise TypeError("numpy has no bfloat16 type until ml_dtypes is "
                        "imported (jax imports it)") from e
    return t.view(torch.int16).numpy().view(bf16)


def to_numpy(tree):
    """``tree`` (a parameter dict, a ``TrainState``, ...) with every tensor
    leaf a numpy array on the host, bf16 as numpy's ``bfloat16``."""
    return tree_map(_numpy, tree)
