"""Async host pipeline: detokenize and journal bookkeeping off the tick path
(twin of ``repro/serve/pipeline.py``).

The synchronous engine interleaves device work with host work every tick:
replay the tick, download the (steps, B) token block, extend each
request's output list, journal (fsync) the fresh tokens. The card idles
through that Python. :class:`HostPipeline` moves everything after the
replay onto one background worker thread fed through a *bounded* queue:

  * the main thread keeps only the (B,) watchdog-sentinel download per
    tick (poison detection timing is unchanged) and hands the token block
    over;
  * the hand-off: the graph tick writes its block into the engine's static
    ``_block``, which the next replay overwrites. So :meth:`emit_chunk`
    copies the block on the current stream into one of a ring of pinned
    host buffers and records a CUDA event; the worker waits on the event
    and reads the host buffer, never ``_block``. A ring slot is reused only
    after the worker has released it. A CPU tensor or a numpy array is
    copied on the spot;
  * the worker extends ``Request.out`` and performs **all** journal writes
    (admission records, token emits, done / fail marks) in queue order.
    One writer thread keeps the journal's append-then-fsync order the
    synchronous engine's, so :meth:`ServeEngine.resume` replays an async
    engine's journal unchanged (either package's resume);
  * the bounded queue is backpressure: if the host falls behind, the main
    thread blocks on ``put`` instead of buffering without bound;
  * worker exceptions are captured and re-raised on the main thread at the
    next ``check()`` / ``flush()``: a failed fsync fails the engine, not a
    daemon thread's stderr.

Shutdown: ``flush()`` drains (blocks until every queued item is processed),
``close()`` drains then joins the thread. Stats are accumulated on the
worker and folded into the engine's counters at ``drain_stats()``.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class _PinnedRing:
    """``n`` pinned host buffers, each with a release flag: the producer
    stages a device tensor into the next free one (an async copy on the
    current stream plus an event); the consumer waits on the event, reads,
    and releases the slot."""

    def __init__(self, n: int):
        self.bufs: list[torch.Tensor | None] = [None] * n
        self.free = [threading.Event() for _ in range(n)]
        for f in self.free:
            f.set()
        self.i = 0

    def reserve(self, numel: int) -> None:
        """Allocate every buffer now (pinned allocation is slow the first
        time; a serving engine pays it at construction)."""
        self.bufs = [torch.empty(max(numel, 64), dtype=torch.int64,
                                 pin_memory=True) for _ in self.bufs]

    def stage(self, x: torch.Tensor):
        k = self.i
        self.i = (k + 1) % len(self.bufs)
        self.free[k].wait()
        self.free[k].clear()
        buf = self.bufs[k]
        if buf is None or buf.numel() < x.numel() or buf.dtype != x.dtype:
            buf = torch.empty(max(x.numel(), 64), dtype=x.dtype,
                              pin_memory=True)
            self.bufs[k] = buf
        view = buf[:x.numel()].view(x.shape)
        view.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        return view, ev, k

    def release(self, k: int) -> None:
        self.free[k].set()


class HostPipeline:
    """One background worker consuming (chunk | admit | journal) items."""

    def __init__(self, journal=None, depth: int = 4,
                 reserve: int | None = None):
        self.journal = journal
        depth = max(1, int(depth))
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        # staged buffers can be queued (depth), held by the worker (1) and
        # being filled (1) at once
        self._ring = _PinnedRing(depth + 2)
        if reserve is not None:  # a CUDA engine's largest token block
            self._ring.reserve(reserve)
        self._lock = threading.Lock()
        self._stats = {"transfers": 0, "chunks": 0, "tokens": 0}
        self._exc: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, name="serve-host-pipeline", daemon=True)
        self._thread.start()

    # -- producer side (engine main thread) --------------------------------
    def _stage(self, x):
        """(host copy or pinned view, CUDA event or None, ring slot or
        None) of a token tensor: the worker never reads the producer's
        buffer."""
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return self._ring.stage(x)
        if isinstance(x, torch.Tensor):
            return x.detach().numpy().copy(), None, None
        return np.array(x, copy=True), None, None

    def emit_chunk(self, items, toks) -> None:
        """``items``: ((slot, Request), ...) for the healthy slots of one
        tick; ``toks``: the (steps, B) token block. The worker reads the
        staged copy, detokenizes into each request and journals."""
        self._open()
        self._put(("chunk", tuple(items), self._stage(toks)))

    def emit_admit(self, items, firsts) -> None:
        """``items``: ((row, Request), ...) of one admission dispatch;
        ``firsts``: the first-token vector (or scalar)."""
        self._open()
        self._put(("admit", tuple(items), self._stage(firsts)))

    def journal_call(self, method: str, *args) -> None:
        """Route a journal write (submit/done/fail) through the worker so it
        lands *after* every token emit already queued."""
        if self.journal is not None:
            self._put(("journal", method, args))

    def flush(self) -> None:
        """Block until the queue is fully processed; surface worker errors."""
        self._q.join()
        self.check()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(("stop",))
        self._thread.join(timeout=60.0)
        self.check()

    def check(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def drain_stats(self) -> dict:
        """Return-and-zero the worker-side counters (fold into engine
        stats on the main thread)."""
        with self._lock:
            out, self._stats = self._stats, {k: 0 for k in self._stats}
        return out

    @property
    def depth(self) -> int:
        return self._q.qsize()

    def _open(self) -> None:
        self.check()
        if self._closed:
            raise RuntimeError("HostPipeline is closed")

    def _put(self, item) -> None:
        self._open()
        self._q.put(item)  # blocks when full: bounded backpressure

    # -- worker side --------------------------------------------------------
    def _bump(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._stats[k] += v

    @staticmethod
    def _read(staged) -> np.ndarray:
        host, ev, _k = staged
        if ev is not None:
            ev.synchronize()
            return host.numpy().copy()
        return np.asarray(host)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            staged = item[2] if item[0] in ("chunk", "admit") else None
            try:
                kind = item[0]
                if kind == "stop":
                    return
                if self._exc is not None:
                    continue  # poisoned: drain without side effects
                if kind == "chunk":
                    _, items, _ = item
                    block = self._read(staged)
                    self._bump(transfers=1, chunks=1,
                               tokens=block.shape[0] * len(items))
                    for slot, req in items:
                        fresh = [int(t) for t in block[:, slot]]
                        req.out.extend(fresh)
                        if self.journal is not None:
                            self.journal.emit(req.rid, fresh)
                elif kind == "admit":
                    _, items, _ = item
                    vals = self._read(staged).reshape(-1)
                    self._bump(transfers=1, tokens=len(items))
                    for row, req in items:
                        tok = int(vals[row])
                        req.out.append(tok)
                        if self.journal is not None:
                            self.journal.emit(req.rid, [tok])
                elif kind == "journal":
                    _, method, args = item
                    if self.journal is not None:
                        getattr(self.journal, method)(*args)
            except BaseException as e:  # noqa: BLE001 — surfaced to main
                self._exc = e
            finally:
                if staged is not None and staged[2] is not None:
                    self._ring.release(staged[2])
                self._q.task_done()
