"""Carry the reference's parameters into the port.

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
leaf must have the port's shape and dtype for ``cfg``; nothing is cast. A
reference leaf that the port's tree does not name is refused too: a
dropped leaf (a QKV bias, say) would otherwise show only as a logit
difference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.transformer import param_shapes


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # owned and writable
    if a.dtype.name == "bfloat16":  # no numpy dtype: move the raw bits
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: dict, cfg, device: str | torch.device = "cuda"
                    ) -> dict:
    dev = resolve(device)

    def walk(shapes: dict, src: dict, path: str) -> dict:
        extra = sorted(set(src) - set(shapes))
        if extra:
            raise KeyError(f"reference leaves {[path + e for e in extra]} "
                           f"have no place in the port's tree for "
                           f"{cfg.name}")
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
            if t.dtype != sp.dtype:
                raise TypeError(f"{path}{name}: dtype {t.dtype} != "
                                f"{sp.dtype}")
            out[name] = t.to(dev)
        return out

    return walk(param_shapes(cfg), tree, "")
