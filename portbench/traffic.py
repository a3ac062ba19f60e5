"""The one traffic generator: requests of a cell, drawn from the seed and
the cell file's parameters.

Lengths come from a distribution (``uniform`` over whole numbers, or
``lognormal`` by its median and sigma, clipped) and arrivals, in an open
loop, at a fixed rate with exponential gaps (``poisson``). Every draw is
taken at
stratified quantiles: the requests come in blocks of ``block``, and each
block holds the same ``block`` quantiles of each distribution, in an order
the seed permutes (each quantity its own permutation). So every seed sends
the same sizes and gaps block by block, in another order, and a window
that takes a few blocks sees almost the same work under every seed. The
seed also draws the prompts' token ids.

In a closed loop each of ``clients`` clients sends its next request when
the last one has finished. With ``stagger`` the first request of each
client keeps only a share of its output (the shares spread evenly over the
clients, permuted by the seed, and at least two tokens), so that the
slots start at staggered points of their requests, as in a loop that has
run for a while.
"""
from __future__ import annotations

import math
import statistics

import numpy as np


def quantile(spec: dict, u: float) -> float:
    if spec["dist"] == "uniform":
        lo, hi = spec["min"], spec["max"]
        return lo + min(math.floor(u * (hi - lo + 1)), hi - lo)
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist().inv_cdf(u)
        x = round(spec["median"] * math.exp(spec["sigma"] * z))
        return min(max(x, spec["min"]), spec["max"])
    if spec["dist"] == "exponential":
        return -math.log(1.0 - u) * spec["mean"]
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def stratified(spec: dict, n: int, block: int, rng) -> list:
    """``n`` draws, each block of ``block`` the distribution's quantiles
    at (i + 0.5) / block in an order drawn from ``rng``. For a
    distribution given by its ``mean`` (the arrival gaps) the block is
    scaled to that mean: the quantiles alone leave out the tail's part."""
    base = [quantile(spec, (i + 0.5) / block) for i in range(block)]
    if "mean" in spec:
        base = [x * spec["mean"] * block / sum(base) for x in base]
    out = []
    while len(out) < n:
        out.extend(base[i] for i in rng.permutation(block))
    return out[:n]


def requests(traffic: dict, vocab: int, seed: int, n: int | None = None
             ) -> list[dict]:
    """The cell's request list: ``rid``, ``prompt`` (int32 ids),
    ``max_new`` and, in an open loop, ``offset`` (seconds after the loop's
    start at which it falls due)."""
    n = n or traffic["requests"]
    block = traffic["block"]
    seed = int(seed) % (1 << 64)
    rng = np.random.default_rng(seed)
    plen = stratified(traffic["prompt"], n, block, rng)
    olen = stratified(traffic["output"], n, block, rng)
    out = [{"rid": i, "prompt_len": int(p), "max_new": int(o)}
           for i, (p, o) in enumerate(zip(plen, olen))]
    if traffic["loop"] == "open":
        if traffic["arrivals"] != "poisson":
            raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
        spec = {"dist": "exponential", "mean": 1.0 / traffic["rate"]}
        gaps = stratified(spec, n, block, rng)
        t = 0.0
        for r, g in zip(out, gaps):
            t += g
            r["offset"] = t
    elif traffic.get("stagger"):
        c = traffic["clients"]
        share = [(i + 0.5) / c for i in range(c)]
        for r, i in zip(out, rng.permutation(c)):
            r["max_new"] = max(2, math.ceil(r["max_new"] * share[i]))
    ids = np.random.default_rng([seed, 1])
    for r in out:
        r["prompt"] = ids.integers(0, vocab, r.pop("prompt_len"),
                                   dtype=np.int32)
    return out
