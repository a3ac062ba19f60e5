"""The traced stretch: ``torch.profiler`` over part of the window, read
back from its Chrome trace.

What the readers get (times in seconds, on the profiler's clock):
``device`` (every kernel, copy and fill on the card: name, start, end,
correlation id), ``launches`` (the host's ``cudaGraphLaunch`` calls:
start, end, correlation id), ``spans`` (the loop's ``portbench.*`` marks:
name, start, end) and ``stretch`` (from the first mark's start to the last
one's end).
"""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def profiler(on_trace_ready):
    """A profiler whose ``start()`` only sets itself up (warm-up); the
    next ``step()`` starts recording and the one after stops it and hands
    the trace to ``on_trace_ready``."""
    import torch
    from torch.profiler import ProfilerAction, ProfilerActivity

    actions = (ProfilerAction.WARMUP, ProfilerAction.RECORD_AND_SAVE)
    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=lambda n: actions[n] if n < 2 else ProfilerAction.NONE,
        on_trace_ready=on_trace_ready)


def read(prof) -> dict:
    """Export ``prof``'s trace to a temporary file, parse it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)


def parse(events: list[dict]) -> dict:
    device, launches, spans = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((name, t0, t1, corr))
        elif cat == "cuda_runtime" and name.startswith("cudaGraphLaunch"):
            launches.append((t0, t1, corr))
        elif cat == "user_annotation" and name.startswith("portbench."):
            spans.append((name, t0, t1))
    device.sort(key=lambda x: x[1])
    launches.sort()
    spans.sort(key=lambda x: x[1])
    stretch = ((spans[0][1], max(s[2] for s in spans)) if spans
               else (0.0, 0.0))
    return {"device": device, "launches": launches, "spans": spans,
            "stretch": stretch}


def busy(trace: dict) -> list[tuple[float, float]]:
    """The union of device intervals inside the stretch."""
    lo, hi = trace["stretch"]
    out: list[list[float]] = []
    for _, t0, t1, _ in trace["device"]:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [tuple(x) for x in out]


def busy_s(trace: dict) -> float:
    return sum(t1 - t0 for t0, t1 in busy(trace))


def step_spans(trace: dict) -> dict[int, tuple[float, float]]:
    """The loop's step index -> its span."""
    out = {}
    for name, t0, t1 in trace["spans"]:
        if name.startswith("portbench.step#"):
            out[int(name.split("#", 1)[1])] = (t0, t1)
    return out


def host_doing(trace: dict, t: float) -> str:
    """What the host was doing at ``t``: in ``step()``, waiting for an
    arrival, or the loop's own bookkeeping."""
    for name, t0, t1 in trace["spans"]:
        if t0 <= t <= t1:
            return "step" if name.startswith("portbench.step") else "wait"
    return "bookkeeping"


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, named by what the host was doing in their middle."""
    tot: dict[str, float] = {}
    for name, t0, t1, _ in trace["device"]:
        tot[name] = tot.get(name, 0.0) + (t1 - t0)
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace["stretch"]
    edges = [lo] + [x for iv in busy(trace) for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[host_doing(trace, (a + b) / 2), b - a]
                          for a, b in gaps[:top]]}
