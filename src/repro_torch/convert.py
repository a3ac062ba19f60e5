"""Carry the reference's parameters into the port.

``params_from_jax`` takes the reference's parameter tree as numpy arrays,
i.e. ``jax.tree.map(np.asarray, repro.models.transformer.init_params(key,
cfg))`` (layers stacked under ``segments/seg0/0/...``), and returns the
port's parameter dict, so that both packages compute the same function.
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
        out = {}
        for name, shape in shapes.items():
            if name not in src:
                raise KeyError(f"reference tree has no {path}{name}")
            if isinstance(shape, dict):
                out[name] = walk(shape, src[name], f"{path}{name}/")
                continue
            t = _tensor(np.asarray(src[name]))
            if tuple(t.shape) != shape and t.dim() + 1 == len(shape):
                t = t[None]  # an unstacked one-layer segment
            if tuple(t.shape) != shape:
                raise ValueError(f"{path}{name}: {tuple(t.shape)} != {shape}")
            out[name] = t.to(dev)
        return out

    return walk(param_shapes(cfg), tree, "")
