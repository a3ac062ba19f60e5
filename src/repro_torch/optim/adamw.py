"""AdamW with decoupled weight decay and global-norm clipping (twin of
``repro/optim/adamw.py``).

The moments and a master copy of the weights are float32 whatever the
parameter dtype, so repeated bf16 rounding never accumulates across steps;
the parameters are the master cast to ``param_dtype``. Only leaves of rank
>= 2 decay (norm scales and biases are exempt). Trees are nested dicts of
tensors; the state is an :class:`AdamWState` of such dicts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import Spec, spec
from repro_torch.util.tree import tree_leaves, tree_map, unflatten_like

_F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    master: dict  # float32 master weights
    mu: dict  # first moment, float32
    nu: dict  # second moment, float32


def adamw_init(params: dict) -> AdamWState:
    """Step 0, the master a float32 copy of ``params`` (never aliased, even
    for float32 parameters), zero moments; on the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    master = tree_map(lambda x: x.detach().to(_F32, copy=True), params)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), master,
                      tree_map(torch.zeros_like, master),
                      tree_map(torch.zeros_like, master))


def adamw_state_shapes(param_shapes: dict) -> AdamWState:
    """The state's :class:`Spec` tree (no allocation)."""
    def f32(t):
        return tree_map(lambda s: spec(s.shape, _F32), t)
    return AdamWState(Spec((), torch.int32), f32(param_shapes),
                      f32(param_shapes), f32(param_shapes))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf in float32, the leaves
    summed in the reference's order (sorted keys)."""
    return torch.sqrt(sum(torch.sum(x.to(_F32) ** 2)
                          for x in tree_leaves(tree)))


def adamw_update(grads: dict, state: AdamWState, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 param_dtype: torch.dtype = torch.bfloat16,
                 donate: bool = False):
    """Returns (new params in ``param_dtype``, new state, {"grad_norm"}).

    ``donate=True`` writes the new master and moments into ``state``'s own
    tensors, leaf by leaf (the reference's donated state buffer): the same
    values, with one leaf's temporaries at a time instead of a second
    state. ``state`` must not be read afterwards."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.to(_F32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    lr = torch.as_tensor(lr, dtype=_F32).to(stepf.device)

    masters, mus, nus = [], [], []
    for g, w, m, v in zip(tree_leaves(grads), tree_leaves(state.master),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.to(_F32) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if w.dim() >= 2:  # decay matrices only
            u = u + weight_decay * w
        w_new = w - lr * u
        if donate:
            for dst, src in ((w, w_new), (m, m_new), (v, v_new)):
                dst.copy_(src)
            w_new, m_new, v_new = w, m, v
        masters.append(w_new)
        mus.append(m_new)
        nus.append(v_new)
    master = unflatten_like(state.master, masters)
    params = tree_map(lambda w: w.to(param_dtype), master)
    new = AdamWState(step, master, unflatten_like(state.mu, mus),
                     unflatten_like(state.nu, nus))
    return params, new, {"grad_norm": gnorm}
