"""Elastic scaling: re-shard a state onto another mesh (twin of
``repro/launch/elastic.py``).

When a rank is dropped or added, the controller re-derives every leaf's
placement from the same rule engine on the *new* mesh: the
divisibility-checked fallback chain picks new axes by itself (a vocabulary
split 4-way re-splits 2-way, or falls back to replication on one rank).

The reference's arrays carry their sharding; the port's local shards do
not, so a placed state is a :class:`Placed` (this rank's shards, the mesh
and the specs they were cut by). :func:`remesh_state` gathers it to host
numpy by its own specs (a collective over its mesh), hands the full
arrays to every rank of the world, and re-slices them by the new mesh's
specs; :func:`reshard_checkpoint` reads a committed checkpoint (the
``.npy`` layout either package writes: it always holds the full state) and
slices it for the new mesh. Every rank of the world calls either one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore
from repro_torch.launch import sharding as shlib
from repro_torch.util.tree import tree_map


class Placed(NamedTuple):
    """This rank's shards of a tree (None on a rank outside ``mesh``), the
    mesh and the spec tree they were cut by."""

    tree: object
    mesh: object
    specs: object


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _place(full, new_mesh, rules, device) -> Placed:
    """Slice the full host tree ``full`` for this rank of ``new_mesh``."""
    specs = shlib.param_specs(full, new_mesh, rules)
    if new_mesh.coords is None:
        return Placed(None, new_mesh, specs)
    tensors = tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(device),
                       full)
    return Placed(shlib.shard_tree(tensors, specs, new_mesh), new_mesh,
                  specs)


def remesh_state(state, new_mesh, rules: dict | None = None) -> Placed:
    """Re-place ``state`` on ``new_mesh``: a :class:`Placed` is gathered
    to host numpy by its own specs (on its mesh) and broadcast from the
    first rank of that mesh to the world; any other tree is taken as the
    full state. Returns this rank's :class:`Placed` on ``new_mesh``."""
    import torch.distributed as dist

    if isinstance(state, Placed):
        full = None
        if state.mesh.coords is not None:
            full = tree_map(_host, shlib.gather_tree(state.tree, state.specs,
                                                     state.mesh))
        src = int(state.mesh.ranks.reshape(-1)[0])
        box = [full]
        dist.broadcast_object_list(box, src=src)
        full = box[0]
        device = _device(state.tree)
    else:
        full = tree_map(_host, state)
        device = _device(state)
    return _place(full, new_mesh, rules, device)


def _device(tree) -> torch.device:
    from repro_torch.util.tree import tree_leaves

    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    return leaves[0].device if leaves else torch.device("cpu")


def reshard_checkpoint(ckpt_dir: str, like, new_mesh, step: int | None = None,
                       rules: dict | None = None):
    """Load the latest (or given) checkpoint and place it on ``new_mesh``.

    Returns (step, this rank's :class:`Placed`). ``like`` provides the tree
    structure (``Spec`` leaves or tensors); the leaves come back as tensors
    on ``like``'s device (the CPU for ``Spec`` leaves)."""
    s = latest_step(ckpt_dir) if step is None else step
    if s is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    host_state, _ = restore(ckpt_dir, s, like)
    return s, _place(tree_map(_host, host_state), new_mesh, rules,
                     _device(host_state))
