"""Quantities the metric readers share, from a run's records.

``run`` is the dict :mod:`portbench.run` hands every reader: ``cfg`` (the
configuration file), ``records`` and ``steps`` (:mod:`portbench.loop`),
``window`` (its open and closing edges), ``stats`` (the engine's counters
at those edges), ``setup_s``, and in a traced run ``trace``
(:mod:`portbench.trace`).
"""
from __future__ import annotations

from portbench import stats, trace as tr, work


def window_steps(run) -> list[int]:
    """Indices of the steps whose deliveries fall inside the window."""
    return [k for k, s in enumerate(run["steps"])
            if stats.inside(s["t1"], run["window"])]


def token_flops(cfg: dict, prompt: int, j: int) -> float:
    """Model FLOPs that produced served token ``j`` of a request."""
    if j == 0:
        return work.prefill_flops(cfg, prompt)
    return work.decode_flops(cfg, prompt + j - 1)


def window_flops(run) -> float:
    """Model FLOPs of every token delivered inside the window."""
    cfg, w = run["cfg"], run["window"]
    total = 0.0
    for rec in run["records"]:
        p, seen = len(rec["prompt"]), 0
        for t, n in rec["deliveries"]:
            if stats.inside(t, w):
                total += sum(token_flops(cfg, p, j)
                             for j in range(seen, seen + n))
            seen += n
    return total


def admissions(run, ks) -> list[dict]:
    ks = set(ks)
    return [r for r in run["records"] if r["admit_step"] in ks]


def tick_rows(run, k: int) -> list[list[tuple[int, int]]]:
    """The decode launches of step ``k``'s tick: per decode step, the
    (1 query row, keys before it) of each live request."""
    steps = run["steps"][k]["decode_steps"]
    rows = [[] for _ in range(steps)]
    for rec in run["records"]:
        seen = 0
        for i, (t, n) in enumerate(rec["deliveries"]):
            if t == run["steps"][k]["t1"]:
                first = seen + (1 if rec["admit_step"] == k else 0)
                p = len(rec["prompt"])
                for s in range(steps):
                    rows[s].append((1, p + first + s - 1))
                break
            seen += n
    return rows


def flash_bound_s(run, ks) -> float:
    """The least time of the ``flash_attn_lib`` launches of steps ``ks``:
    each decode step's launch over its live rows, and each step's prefill
    launches taken together (the larger of their summed FLOPs and bytes
    bounds, which is no more than the sum of their own bounds), every
    layer."""
    cfg = run["cfg"]
    total = 0.0
    for k in ks:
        pre = [(len(r["prompt"]), 0) for r in admissions(run, [k])]
        if pre:
            total += work.bound_s(*work.flash_launch(cfg, pre))
        for rows in tick_rows(run, k):
            if rows:
                total += work.bound_s(*work.flash_launch(cfg, rows))
    return total * work.layer_count(cfg)


def traced_steps(run) -> dict[int, tuple[float, float]]:
    """The steps inside the traced stretch, with their spans."""
    return tr.step_spans(run["trace"]) if run.get("trace") else {}


def device_s(run, match) -> float:
    return sum(t1 - t0 for name, t0, t1, _ in run["trace"]["device"]
               if match(name))


def flash_roofline(run) -> float | None:
    ks = traced_steps(run)
    spent = device_s(run, lambda n: "flash_attn" in n) if ks else 0.0
    if not spent:
        return None
    return 100.0 * flash_bound_s(run, ks) / spent


def idle_share(run) -> float | None:
    t = run.get("trace")
    if not t or not t["device"]:
        return None
    lo, hi = t["stretch"]
    return 100.0 * (1.0 - tr.busy_s(t) / (hi - lo))


def tick_device_ms(run) -> float | None:
    """Device ms per decode step of the ticks in the traced stretch: the
    kernels of each step's last graph launch (its tick's replay)."""
    spans = traced_steps(run)
    if not spans:
        return None
    t = run["trace"]
    by_corr: dict = {}
    for _, t0, t1, corr in t["device"]:
        if corr is not None:
            by_corr[corr] = by_corr.get(corr, 0.0) + (t1 - t0)
    ms = steps = 0.0
    for k, (a, b) in spans.items():
        n = run["steps"][k]["decode_steps"]
        inside = [c for t0, t1, c in t["launches"] if a <= t0 and t1 <= b]
        if not n or not inside or inside[-1] not in by_corr:
            continue
        ms += by_corr[inside[-1]] * 1e3
        steps += n
    return ms / steps if steps else None
