"""Ahead-of-time warm-up for the serving tier (twin of ``repro/serve/aot.py``):
the bucket table and what construction prepares.

The reference moves every XLA compile to engine construction: the decode
tick at each power-of-two chunk size and one packed admission program per
(bucket, pack) pair, kept in a process-wide executable cache. Here the
counterpart of a compiled executable is a captured CUDA graph:

  * :class:`BucketTable` — a small ascending set of prefill lengths. A
    prompt admits at the smallest bucket that holds it (right-padded;
    ``models.transformer.prefill_padded`` computes the real rows as an
    exact-length prefill does and masks the pad tail dead), so the engine
    serves any prompt length from a handful of programs. Prompts longer
    than the largest bucket fall back to an exact-length prefill, counted
    in ``stats["aot_fallbacks"]``.
  * The engine captures one graph per (bucket, pack) at construction, in
    the memory pool of its tick graphs: the whole packed admission
    (prefill, the splice of each row into its slot, the greedy first
    tokens written into the static slot state). A graph bakes in the
    addresses of one engine's pool and slot state, so the table is per
    engine, not per process, and ``stats["aot_compiles"]`` counts what each
    engine prepared (the reference's counts fresh compiles of its shared
    cache). On the CPU and with ``graph=False`` the table holds the eager
    callables, so the counters mean the same thing: was this shape
    prepared at construction.

:func:`pack_sizes`, :func:`tick_chunk_sizes` and :func:`compile_count` are
the reference's. :func:`mesh_key` is the identity of a meshed engine's
mesh, part of every program key (a graph's collectives are bound to its
mesh's groups); :func:`call_matched` replays a program after copying its
inputs into the static buffers it was captured on, counting the ones that
had to be moved (another device, or another shape of the same size), as
the reference counts its re-placed inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class BucketTable:
    """Ascending, de-duplicated prefill length buckets."""

    buckets: tuple[int, ...]

    def __post_init__(self):
        bs = tuple(int(b) for b in self.buckets)
        if not bs:
            raise ValueError("BucketTable needs at least one bucket")
        if any(b < 1 for b in bs):
            raise ValueError(f"bucket lengths must be positive: {bs}")
        if list(bs) != sorted(set(bs)):
            raise ValueError(f"buckets must be ascending and unique: {bs}")
        object.__setattr__(self, "buckets", bs)

    @classmethod
    def for_cache(cls, cache_len: int,
                  buckets=DEFAULT_BUCKETS) -> "BucketTable":
        """Clip a candidate set to the slot cache: buckets longer than
        ``cache_len`` can never admit (submit rejects those prompts), and an
        empty survivor set degenerates to one full-cache bucket."""
        bs = sorted({int(b) for b in buckets if 0 < int(b) <= int(cache_len)})
        return cls(tuple(bs) if bs else (int(cache_len),))

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest bucket holding an ``n``-token prompt; an exact-boundary
        prompt (``n == bucket``) uses that bucket, not the next one. ``None``
        = longer than every bucket (exact-length fallback)."""
        for b in self.buckets:
            if n <= b:
                return b
        return None


def mesh_key(mesh) -> Optional[tuple]:
    """Hashable identity of a mesh for program keys (``None`` without
    one): axis names, shape and the global ranks."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(mesh.shape.values()),
            None if mesh.ranks is None
            else tuple(int(r) for r in mesh.ranks.reshape(-1)))


def call_matched(replay, static: tuple, args: tuple):
    """Copy each of ``args`` into the static buffer at the same place of
    ``static`` (the inputs a graph baked in), then call ``replay``. An arg
    that is its buffer is left; a host array, or a tensor on the buffer's
    device with its shape, is the ordinary upload; a tensor on another
    device or of another shape with the same element count is moved there
    and counted. Returns (``replay()``'s result, the count)."""
    import numpy as np
    import torch

    moved = 0
    for buf, x in zip(static, args):
        if x is buf:
            continue
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        elif x.device != buf.device or x.shape != buf.shape:
            if x.numel() != buf.numel():
                raise ValueError(f"input of {tuple(x.shape)} cannot fill a "
                                 f"static buffer of {tuple(buf.shape)}")
            moved += 1
        buf.copy_(x.reshape(buf.shape))
    return replay(), moved


def pack_sizes(max_pack: int, slots: int) -> tuple[int, ...]:
    """Powers of two up to ``min(max_pack, slots)``: the packed-admission
    group sizes the engine prepares (a group of e.g. 5 admits as 4 + 1)."""
    cap = max(1, min(int(max_pack), int(slots)))
    out = [1]
    while out[-1] * 2 <= cap:
        out.append(out[-1] * 2)
    return tuple(out)


def _pow2_upto(n: int):
    s = 1
    while s <= max(1, int(n)):
        yield s
        s *= 2


def tick_chunk_sizes(horizon: int) -> tuple[int, ...]:
    """The engine quantizes tick chunks to powers of two <= horizon."""
    return tuple(_pow2_upto(horizon))


def compile_count(table: "BucketTable", max_pack: int, slots: int,
                  horizon: int) -> int:
    """How many programs a full warm-up prepares (the bucket x pack grid
    plus the power-of-two tick chunks): surfaced by the CLI so operators
    see what construction will pay before it happens."""
    return (len(table.buckets) * len(pack_sizes(max_pack, slots))
            + len(tick_chunk_sizes(horizon)))
