"""Fault-tolerant checkpoints on the reference's layout (twin of
``repro/checkpoint/checkpoint.py``): atomic, manifest-verified, keep-K.

Layout per step::

    <dir>/step_000000420/
        manifest.json       # leaf names, files, shapes, dtypes, checksums
        arr_00000.npy ...   # one .npy per leaf
    <dir>/LATEST            # text: the last committed step

Leaves are named and ordered as the reference flattens the same state
(:mod:`repro_torch.util.tree`: sorted dict keys, ``NamedTuple`` fields by
name, ``None`` absent, an ``InterpLibrary`` as its ``coeffs``), and bf16
is stored as its ``uint16`` bits with ``"bfloat16"`` in the manifest, so
either package reads what the other writes. No ``ml_dtypes`` is needed:
bf16 moves as raw bits between numpy and torch.

Write protocol (crash-safe at every point): the leaves and the manifest
go into ``step_X.tmp/``, which is renamed to ``step_X`` (the commit), then
``LATEST`` is rewritten through a temporary file and a rename. A crash
between the two leaves a complete but unreferenced step; ``latest_step``
trusts only ``LATEST`` (and only if its step has a manifest), and the
manager's garbage collection removes strays.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil

import numpy as np
import torch

from repro_torch.util.journal import atomic_write_text
from repro_torch.util.tree import leaves_with_paths, unflatten_like


def _checksum(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _to_savable(leaf) -> tuple[np.ndarray, str]:
    """(the array np.save writes, the logical dtype name). bf16 -- a torch
    tensor, or a numpy array of ``ml_dtypes``' bfloat16 -- becomes its
    uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _from_saved(a: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(directory: str | pathlib.Path, step: int, tree,
         extra: dict | None = None, verify: bool = True) -> pathlib.Path:
    """Commit ``tree`` as step ``step`` of ``directory``; returns the step's
    directory."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:09d}"
    tmp = d / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (name, leaf) in enumerate(leaves_with_paths(tree)):
        a, logical = _to_savable(leaf)
        fn = f"arr_{i:05d}.npy"
        with open(tmp / fn, "wb") as f:
            np.save(f, a)
            f.flush()
            os.fsync(f.fileno())  # leaf bytes durable before the manifest
        manifest["leaves"].append({
            "name": name, "file": fn, "shape": list(a.shape),
            "dtype": logical, "sha": _checksum(a) if verify else "",
        })
    atomic_write_text(tmp / "manifest.json", json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    atomic_write_text(d / "LATEST", str(step))  # atomic pointer flip
    return final


def latest_step(directory: str | pathlib.Path) -> int | None:
    """The step ``LATEST`` names, or None where there is no pointer or it
    is ahead of the data (no manifest under its step)."""
    f = pathlib.Path(directory) / "LATEST"
    if not f.exists():
        return None
    step = int(f.read_text().strip())
    if not (pathlib.Path(directory) / f"step_{step:09d}"
            / "manifest.json").exists():
        return None
    return step


def restore(directory: str | pathlib.Path, step: int, like,
            verify: bool = True):
    """Step ``step`` into the structure of ``like``; returns (tree, extra).

    Each leaf is a tensor of the dtype the manifest records, on the device
    of ``like``'s leaf where that is a tensor (else the CPU), and must have
    its shape. A leaf whose bytes do not match its checksum, or whose
    shape differs, raises ``ValueError`` (the reference asserts)."""
    d = pathlib.Path(directory) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}
    out = []
    for name, leaf in leaves_with_paths(like):
        if name not in by_name:
            raise ValueError(f"checkpoint step {step} has no leaf {name}")
        e = by_name[name]
        a = np.load(d / e["file"])
        if verify and e["sha"] and _checksum(a) != e["sha"]:
            raise ValueError(f"corrupt leaf {name} in {d}")
        t = _from_saved(a, e["dtype"])
        want = tuple(getattr(leaf, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"leaf {name}: shape {tuple(t.shape)} != "
                             f"{want}")
        if isinstance(leaf, torch.Tensor):
            t = t.to(leaf.device)
        out.append(t)
    return unflatten_like(like, out), manifest["extra"]


@dataclasses.dataclass
class CheckpointManager:
    """Save every N steps, keep the newest K, resume from the latest."""

    directory: str
    every: int = 100
    keep: int = 3

    def maybe_save(self, step: int, tree, extra: dict | None = None) -> bool:
        if step % self.every:
            return False
        save(self.directory, step, tree, extra)
        self._gc()
        return True

    def _gc(self):
        d = pathlib.Path(self.directory)
        committed = latest_step(d)
        steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            if s != committed:
                shutil.rmtree(d / f"step_{s:09d}", ignore_errors=True)
        for p in d.glob("step_*.tmp"):  # crashed writers
            shutil.rmtree(p, ignore_errors=True)

    def restore_latest(self, like):
        """(step, tree, extra), or (None, None, None) without a committed
        checkpoint."""
        s = latest_step(self.directory)
        if s is None:
            return None, None, None
        tree, extra = restore(self.directory, s, like)
        return s, tree, extra
