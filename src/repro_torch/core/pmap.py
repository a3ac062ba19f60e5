"""Region-parallel execution — the paper's §V future-work line
("Scalability concerns could be addressed by introducing parallelism").

Regions are embarrassingly parallel in every phase of §II generation: the
M/m envelopes, the Eqn 9-10 feasibility searches and the truncation
re-checks of §III all touch one region's (L, U) rows only. ``RegionPool``
wraps a process pool; all submitted callables must be module-level
(picklable) functions. Twin of ``repro/core/pmap.py``, with one change:
workers start by ``spawn``, not ``fork``, because the port's process holds
torch's intra-op threads and a fork of a threaded process can deadlock.

This pool is the ``engine="pooled"`` fallback only: the
default region backend is ``core.batched``, which runs the same per-region
math as one array program over stacked ``(regions, N)`` rows — no pickling,
no per-region Python dispatch — and is bit-identical to the pooled path
(it doubles as the equivalence oracle in tests/core/test_batched.py).
"""
from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
from typing import Callable, Iterable, Sequence


def default_processes() -> int:
    return max(1, min(8, os.cpu_count() or 1))


class RegionPool:
    """map() over per-region work items; transparent when processes <= 1."""

    def __init__(self, processes: int | None = None):
        self.processes = 1 if processes is None else processes
        self._pool = None

    def __enter__(self):
        if self.processes > 1:
            self._pool = mp.get_context("spawn").Pool(self.processes)
        return self

    def __exit__(self, exc_type=None, exc=None, tb=None):
        if self._pool is not None:
            if exc_type is None:
                # clean exit: let in-flight pooled work drain before joining
                # (terminate() here used to kill submitted regions mid-map)
                self._pool.close()
            else:
                self._pool.terminate()
            self._pool.join()
            self._pool = None

    def map(self, fn: Callable, items: Sequence, chunksize: int | None = None):
        if self._pool is None or len(items) <= 1:
            return [fn(it) for it in items]
        cs = chunksize or max(1, len(items) // (4 * self.processes))
        return self._pool.map(fn, items, cs)


@contextlib.contextmanager
def region_pool(processes: int | None):
    with RegionPool(processes) as p:
        yield p
