"""The benchmark's single-threaded load loop around ``ServeEngine``.

Each pass submits every request that has fallen due, calls
``engine.step(horizon)`` once and reads each live request's ``out``:
tokens that appeared during the call are one delivery, stamped with the
host clock when the call returned. In a closed loop each client's next
request falls due when its last one finished; in an open loop requests
fall due at their scheduled offsets from the loop's start, and the loop
sleeps only when nothing is live or queued. How late each request was
submitted after it fell due is kept (``late``).

The loop's own spans (``steps``: each ``step()`` call with the requests it
admitted and the decode steps its tick ran) are kept in memory and, under
a profiler, marked with ``record_function`` (``portbench.step#<k>``, and
``portbench.wait`` around each sleep) so that the trace can name what the
host was doing.
"""
from __future__ import annotations

import collections
import contextlib
import time


class Loop:
    def __init__(self, engine, make_request, reqs: list[dict], traffic: dict,
                 horizon: int, rejected=Exception, clock=time.perf_counter):
        self.engine, self.make_request = engine, make_request
        self.horizon, self.rejected, self.clock = horizon, rejected, clock
        self.closed = traffic["loop"] == "closed"
        self.clients = traffic.get("clients", 0)
        self.reqs = collections.deque(reqs)
        self.records: list[dict] = []
        self.steps: list[dict] = []
        self.late: list[float] = []
        self.live: dict[int, tuple[dict, object]] = {}
        self.ready: collections.deque = collections.deque()
        self.span = lambda name: contextlib.nullcontext()
        self.t0 = None

    # -- arrivals ---------------------------------------------------------
    def start(self) -> None:
        self.t0 = self.clock()
        if self.closed:
            self.ready.extend([self.t0] * self.clients)

    def _next_due(self) -> float | None:
        if self.closed:
            return self.ready[0] if self.ready and self.reqs else None
        return self.t0 + self.reqs[0]["offset"] if self.reqs else None

    def _submit_due(self, now: float) -> None:
        while (due := self._next_due()) is not None and due <= now:
            if self.closed:
                self.ready.popleft()
            r = self.reqs.popleft()
            rec = {"rid": r["rid"], "prompt": r["prompt"],
                   "max_new": r["max_new"], "due": due,
                   "deliveries": [], "admit_step": None, "done": None,
                   "error": None, "seen": 0}
            self.records.append(rec)
            self.late.append(now - due)
            req = self.make_request(r["rid"], r["prompt"], r["max_new"])
            rec["request"] = req
            try:
                self.engine.submit(req)
            except self.rejected as e:
                self._finish(rec, now, error=getattr(e, "reason", str(e)))
                continue
            self.live[r["rid"]] = (rec, req)

    def _finish(self, rec: dict, t: float, error: str | None = None) -> None:
        rec["done"], rec["error"] = t, error
        self.live.pop(rec["rid"], None)
        if self.closed:
            self.ready.append(t)

    # -- one pass ---------------------------------------------------------
    def step(self, deadline: float = float("inf")) -> None:
        now = self.clock()
        self._submit_due(now)
        if not self.live:
            due = self._next_due()
            until = deadline if due is None else min(due, deadline)
            if until > now:
                with self.span("portbench.wait"):
                    time.sleep(until - now)
            return
        k = len(self.steps)
        stats = self.engine.stats
        d0 = stats["decode_steps"]
        with self.span(f"portbench.step#{k}"):
            t0 = self.clock()
            self.engine.step(self.horizon)
            t1 = self.clock()
        admitted = []
        for rec, req in list(self.live.values()):
            n = len(req.out) - rec["seen"]
            if n:
                if not rec["seen"]:
                    rec["admit_step"] = k
                    admitted.append(rec["rid"])
                rec["deliveries"].append((t1, n))
                rec["seen"] += n
            if req.done or req.error:
                self._finish(rec, t1, req.error)
        self.steps.append({"t0": t0, "t1": t1, "admitted": admitted,
                           "decode_steps": stats["decode_steps"] - d0})

    def run_steps(self, n: int) -> None:
        for _ in range(n):
            self.step()

    def run_until(self, t_end: float, on_pass=None) -> float:
        """Passes until one ends at or after ``t_end``; returns that
        pass's end (the window's closing edge)."""
        while True:
            self.step(t_end)
            now = self.clock()
            if on_pass is not None:
                on_pass(now)
            if now >= t_end:
                return now
