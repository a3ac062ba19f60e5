"""Budget-driven auto-assignment of per-layer numerics (twin of
``repro/plan/assign.py``, DESIGN.md §16).

:func:`auto_plan` searches the per-layer (R, degree, segmentation) space
for a :class:`NumericsPlan` that maximizes *modeled* decode tokens/sec
subject to a whole-model output-error budget:

  1. **Candidate slots** are seeded from committed DSE frontier artifacts
     (``artifacts/dse/FRONTIER_*.json``): for each op site, the slot whose
     tables minimize the site's summed frontier delay across the site's
     kinds (``SITE_KINDS``) wins; sites with no frontier coverage fall
     back to the Explorer's per-kind defaults.
  2. **Error composition** is additive over layers and sites: each interp
     site contributes a certified relative-error term derived from its
     kinds' spec widths (the :func:`repro_torch.numerics.ops.softmax_ulp_bound`
     construction generalized per site), weighted by layer sensitivity
     (edge layers 2x — the embedding-adjacent and logits-adjacent blocks
     amplify numerics error the most).
  3. **Greedy budget descent**: start all-interp (max throughput), flip
     the (layer, site) with the largest weighted error to exact until the
     predicted whole-model error fits the budget. Deterministic: ties
     break on (layer index, site order).
  4. **End-to-end verification** (``verify=True``): prefill logits under
     the plan vs. all-exact on deterministic tokens; while the *measured*
     relative error exceeds the budget, keep flipping sites in the same
     greedy order and re-measure. The returned plan's ``measured_error``
     is therefore guaranteed ``<= error_budget`` (worst case the plan
     degenerates to all-exact, error 0).

Candidate slot libraries compile through one Explorer session on the
device (``plan.numerics``) with the envelope probes batched up front
(``prime_envelopes``: the fleet engine answers every (spec, R) in one
stacked program).

The throughput model extends the DSE probe's dispatch/transfer cost model
(:mod:`repro_torch.dse.probe`) below the tick: a fused tick costs
``(DISPATCH_COST_S + TRANSFER_COST_S) / horizon`` per decoded token, and
each layer's op sites add a per-step term — one fused table lookup
(``delay x DELAY_UNIT_S``, delay from the frontier metrics) for an interp
site vs. a multi-op exact transcendental (``EXACT_SITE_COST_S``). All
constants are modeled, not wall clock: scores are bit-reproducible, which
is what lets the bench artifact regress them in CI. The measured error
(``verify``) and the calibration run the port's model and engine on
``device``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Any, Optional

from repro_torch.plan.schema import (SITE_KINDS, SITES, LayerAssign, NumericsPlan,
                               SiteAssign, SlotSpec)

# modeled per-token cost of one op site, per layer (seconds). An exact
# site evaluates a transcendental through multiple vector ops; an interp
# site is one fused ROM lookup whose latency scales with the frontier's
# delay estimate (levels of logic -> modeled seconds).
EXACT_SITE_COST_S = 5e-7
DELAY_UNIT_S = 1e-9
DEFAULT_DELAY = 8.0  # frontier delay proxy when a kind has no coverage

_REPO = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_FRONTIERS = (_REPO / "artifacts" / "dse" / "FRONTIER_8.json",
                     _REPO / "artifacts" / "dse" / "FRONTIER_6.json")


def _site_weight(layer: int, n_layers: int) -> float:
    """Edge layers amplify numerics error the most (embedding-adjacent and
    logits-adjacent); interior layers get unit weight."""
    return 2.0 if layer in (0, n_layers - 1) else 1.0


def _rel_error(kind: str) -> float:
    """Certified relative error of one table kind from its spec widths —
    the ``softmax_ulp_bound`` construction: ~2 output ulps plus half an
    input ulp through the function's slope."""
    from repro_torch.api.config import spec_for

    spec = spec_for(kind)
    return (2.0 ** -spec.out_bits) * 2 + 2.0 ** -(spec.in_bits + 1)


def site_errors() -> dict[str, float]:
    """Per-site certified relative error of an interp assignment.

    softmax composes the exponential and the normalization reciprocal
    exactly as :func:`repro_torch.numerics.ops.softmax_ulp_bound`; rmsnorm rides
    its rsqrt table; the activation site takes the worst of its kinds
    (the plan does not know which activation a layer's FFN uses).
    """
    from repro_torch.api.config import spec_for

    exp, recip = spec_for("exp2neg"), spec_for("recip")
    exp_rel = ((2.0 ** -exp.out_bits) * 2
               + math.log(2.0) * 2.0 ** -(exp.in_bits + 1))
    recip_rel = 2.0 ** -recip.in_bits
    return {
        "softmax": 2 * exp_rel + 2 * recip_rel,
        "rmsnorm": _rel_error("rsqrt"),
        "act": max(_rel_error(k) for k in SITE_KINDS["act"]),
    }


# ---------------------------------------------------------------------------
# frontier-seeded candidate slots
# ---------------------------------------------------------------------------

def load_frontier_candidates(paths=DEFAULT_FRONTIERS, *, target: str = "asic"
                             ) -> dict[str, dict[int, dict[str, Any]]]:
    """``{kind: {lookup_bits: {"area", "delay", "segmentation"}}}`` from
    committed frontier artifacts. Later paths only fill gaps (earlier ones
    win), so FRONTIER_8 (which carries segmentation points) seeds before
    FRONTIER_6. Missing files are skipped — the assigner then falls back
    to default slots rather than failing."""
    out: dict[str, dict[int, dict[str, Any]]] = {}
    for path in paths:
        p = pathlib.Path(path)
        if not p.exists():
            continue
        doc = json.loads(p.read_text())
        groups = doc.get("groups", doc.get("tables", {}).get("groups", {}))
        for entry in groups.get(target, []):
            params, metrics = entry.get("params", {}), entry.get("metrics", {})
            kind, r = params.get("kind"), params.get("lookup_bits")
            if kind is None or r is None:
                continue
            out.setdefault(kind, {}).setdefault(int(r), {
                "area": float(metrics.get("area", 0.0)),
                "delay": float(metrics.get("delay", DEFAULT_DELAY)),
                "segmentation": params.get("segmentation", "uniform"),
            })
    return out


def _choose_slot(site: str, cand: dict[str, dict[int, dict[str, Any]]]
                 ) -> tuple[SlotSpec, float]:
    """The site's slot: the R minimizing summed frontier delay over the
    site's kinds (ties: smaller summed area, then smaller R), restricted
    to heights every kind of the site has coverage for. Returns the slot
    and its summed delay (the throughput model's per-site latency proxy).
    No common coverage -> the default slot at the default delay proxy."""
    kinds = SITE_KINDS[site]
    heights: Optional[set] = None
    for k in kinds:
        rs = set(cand.get(k, {}))
        heights = rs if heights is None else (heights & rs)
    if not heights:
        return SlotSpec(), DEFAULT_DELAY * len(kinds)
    scored = []
    for r in sorted(heights):
        entries = [cand[k][r] for k in kinds]
        delay = sum(e["delay"] for e in entries)
        area = sum(e["area"] for e in entries)
        seg = ("hier" if all(e["segmentation"] == "hier" for e in entries)
               else "uniform")
        scored.append((delay, area, r, seg))
    delay, _area, r, seg = min(scored)
    return SlotSpec(lookup_bits=r, segmentation=seg), delay


# ---------------------------------------------------------------------------
# modeled / measured throughput
# ---------------------------------------------------------------------------

def modeled_tokens_per_s(plan: NumericsPlan, slot_delays: dict[str, float],
                         *, horizon: int = 8,
                         calibration: dict | None = None) -> float:
    """Modeled decode tokens/sec of a fused plan engine: the amortized
    tick dispatch plus every (layer, site) term. ``slot_delays`` maps slot
    keys to their summed frontier delay (``_choose_slot``).

    With ``calibration`` (from :func:`calibrate_slot_latencies`) the
    per-site constants come from *measured* wall clock of the AOT-warmed
    fused tick instead of the modeled ``EXACT_SITE_COST_S`` /
    ``DELAY_UNIT_S`` proxies: ``calibration["site_cost_s"]`` maps
    ``"exact"`` and each slot key to a measured per-(layer, site, step)
    cost. Slots the calibration never measured fall back to the model."""
    from repro_torch.dse.probe import DISPATCH_COST_S, TRANSFER_COST_S

    site_cost = (calibration or {}).get("site_cost_s", {})
    per_step = (DISPATCH_COST_S + TRANSFER_COST_S) / max(1, horizon)
    for _label, _site, a in plan.assignments():
        if a.interp:
            if a.slot.key in site_cost:
                per_step += site_cost[a.slot.key]
            else:
                delay = slot_delays.get(a.slot.key, DEFAULT_DELAY * 2)
                per_step += delay * DELAY_UNIT_S
        else:
            per_step += site_cost.get("exact", EXACT_SITE_COST_S)
    return 1.0 / per_step


def _measure_per_slot_step_s(cfg_run, params, *, horizon: int, slots: int,
                             reps: int, seed: int, device="cuda") -> float:
    """Wall-clock seconds per (slot, decode step) of an AOT-warmed fused
    engine at full occupancy: construction compiles every tick chunk ahead
    of time, one untimed ``step()`` settles admissions, then ``reps``
    timed ticks divide out to the per-slot latency the throughput model
    wants. Measured, not modeled — results vary run to run; callers that
    need reproducible scores keep ``calibration=None``."""
    import time as _time

    import numpy as np
    import torch

    from repro_torch.serve.engine import Request, ServeEngine

    max_new = (2 + reps) * horizon + 1
    cache_len = max(32, 8 + max_new,
                    getattr(cfg_run, "sliding_window", None) or 0)
    eng = ServeEngine(cfg_run, params, slots=slots, cache_len=cache_len,
                      horizon=horizon, aot_buckets=(8,), device=device)
    dev = eng.device
    rng = np.random.default_rng(seed)
    for i in range(slots):
        eng.submit(Request(i, rng.integers(
            0, cfg_run.vocab_size, 4).astype(np.int32), max_new=max_new))
    eng.step()  # admissions + first (untimed) tick
    n0 = eng.stats["decode_steps"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = _time.perf_counter()
    for _ in range(reps):
        eng.step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = _time.perf_counter() - t0
    dn = eng.stats["decode_steps"] - n0
    return dt / max(1, dn) / slots


def calibrate_slot_latencies(cfg, params=None, slots=None, *,
                             horizon: int = 8, engine_slots: int = 2,
                             reps: int = 3, seed: int = 0,
                             device="cuda") -> dict[str, Any]:
    """Measure per-(layer, site, step) decode cost from the AOT-warmed
    fused tick — the ROADMAP's "feed the assigner *measured* per-slot
    latencies" note.

    One uniform-exact engine and one uniform interp-fused engine per
    distinct candidate slot are AOT-warmed and timed at full occupancy;
    subtracting the modeled amortized dispatch and dividing by the number
    of (layer, site) terms turns each whole-engine latency into the
    per-site constant :func:`modeled_tokens_per_s` consumes. The returned
    dict is JSON-ready and travels in the plan snapshot envelope
    (``meta.report.calibration``), so a saved plan records the wall clock
    its scoring used."""
    from repro_torch.dse.probe import DISPATCH_COST_S, TRANSFER_COST_S
    from repro_torch.models import transformer as tf
    from repro_torch.plan.schema import plan_for

    if params is None:
        params = tf.init_params(cfg, seed=seed, device=device)
    if slots is None:
        cand = load_frontier_candidates()
        slots = {s: _choose_slot(s, cand)[0] for s in SITES}
    n_terms = max(1, cfg.n_layers * len(SITES))
    overhead = (DISPATCH_COST_S + TRANSFER_COST_S) / max(1, horizon)
    per_step: dict[str, float] = {}
    site_cost: dict[str, float] = {}

    def record(key: str, cfg_run) -> None:
        t = _measure_per_slot_step_s(cfg_run, params, horizon=horizon,
                                     slots=engine_slots, reps=reps, seed=seed,
                                     device=device)
        per_step[key] = t
        site_cost[key] = max(t - overhead, 1e-12) / n_terms

    record("exact", cfg.replace(numerics="exact", plan=None))
    for slot in {s.key: s for s in slots.values()}.values():
        cfg_i = cfg.replace(numerics="exact", plan=plan_for(
            cfg, backend="interp-fused", slot=slot))
        record(slot.key, cfg_i)
    return {"horizon": int(horizon), "engine_slots": int(engine_slots),
            "reps": int(reps), "n_layers": int(cfg.n_layers),
            "per_slot_step_s": per_step, "site_cost_s": site_cost}


# ---------------------------------------------------------------------------
# the assigner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanReport:
    """The assigner's full accounting — what the bench artifact records."""

    plan: NumericsPlan
    arch: str
    error_budget: float
    predicted_error: float
    measured_error: Optional[float]
    modeled_tokens_per_s: float
    exact_tokens_per_s: float
    site_errors: dict[str, float]
    slot_delays: dict[str, float]
    flipped: tuple  # (layer, site) pairs downgraded to exact, greedy order
    # measured tick calibration (calibrate_slot_latencies) when the scores
    # came from wall clock instead of the modeled constants; None keeps
    # the bit-reproducible modeled scoring
    calibration: Optional[dict] = None

    @property
    def speedup(self) -> float:
        return self.modeled_tokens_per_s / max(self.exact_tokens_per_s, 1e-12)

    def to_dict(self) -> dict[str, Any]:
        return {
            "arch": self.arch,
            "plan": self.plan.to_dict(),
            "error_budget": self.error_budget,
            "predicted_error": self.predicted_error,
            "measured_error": self.measured_error,
            "modeled_tokens_per_s": self.modeled_tokens_per_s,
            "exact_tokens_per_s": self.exact_tokens_per_s,
            "speedup": self.speedup,
            "site_errors": self.site_errors,
            "slot_delays": self.slot_delays,
            "flipped": [list(f) for f in self.flipped],
            "calibration": self.calibration,
        }


def predicted_error(plan: NumericsPlan, errs: dict[str, float]) -> float:
    """Additive sensitivity-weighted composition over every interp site."""
    n = plan.n_layers
    total = 0.0
    for i, la in enumerate(plan.layers):
        w = _site_weight(i, n)
        for s in SITES:
            if la.site(s).interp:
                total += w * errs[s]
    for s in SITES:
        if plan.rest.site(s).interp:
            total += errs[s]
    return total


def _measure_error(cfg_plan, cfg_exact, params, *, seed: int,
                   prompt_len: int, device="cuda", explorer=None) -> float:
    """End-to-end relative output error: prefill logits under the plan vs.
    all-exact numerics on deterministic tokens (max |delta| over the
    logits range)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import get_numerics
    from repro_torch.plan.numerics import plan_numerics

    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg_exact.vocab_size,
                                          (1, prompt_len)).astype(np.int64),
                             device=device)
    cache_len = max(prompt_len + 1,
                    getattr(cfg_exact, "sliding_window", None) or 0)
    with torch.inference_mode():
        got, _ = tf.prefill(params, tokens, cfg_plan,
                            plan_numerics(cfg_plan.plan, explorer=explorer,
                                          device=device), cache_len)
        want, _ = tf.prefill(params, tokens, cfg_exact,
                             get_numerics(cfg_exact), cache_len)
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    scale = max(float(np.abs(want).max()), 1e-12)
    return float(np.abs(got - want).max()) / scale


def auto_plan(cfg, *, error_budget: float, backend: str = "interp-fused",
              frontier_paths=DEFAULT_FRONTIERS, target: str = "asic",
              horizon: int = 8, verify: bool = True, params=None,
              explorer=None, seed: int = 0, prompt_len: int = 16,
              calibrate: bool = False, device="cuda") -> PlanReport:
    """Assign per-layer numerics for ``cfg`` under an output-error budget.

    Returns a :class:`PlanReport` whose ``plan`` maximizes modeled decode
    tokens/sec subject to ``predicted_error <= error_budget`` — and, with
    ``verify=True`` (``params`` on ``device``, or params initialized there
    from ``seed``), subject to the *measured* end-to-end prefill-logit
    error too. ``rest`` (final norm, projector, encoder glue) stays exact: its
    single evaluation per token is throughput-negligible but sits closest
    to the logits.

    ``calibrate=True`` replaces the modeled throughput constants with
    wall clock measured from AOT-warmed fused engines
    (:func:`calibrate_slot_latencies`): the report's tokens/sec columns
    become machine-dependent measurements (stored under
    ``report.calibration`` in the snapshot envelope) instead of the
    bit-reproducible model — never enable it for scores CI regresses.
    """
    n = cfg.n_layers
    errs = site_errors()
    cand = load_frontier_candidates(frontier_paths, target=target)
    slots: dict[str, SlotSpec] = {}
    slot_delays: dict[str, float] = {}
    for s in SITES:
        slot, delay = _choose_slot(s, cand)
        slots[s] = slot
        slot_delays.setdefault(slot.key, delay)

    def build(flipped: set) -> NumericsPlan:
        layers = []
        for i in range(n):
            la = LayerAssign(**{
                s: (SiteAssign("exact", slots[s]) if (i, s) in flipped
                    else SiteAssign(backend, slots[s]))
                for s in SITES})
            layers.append(la)
        return NumericsPlan(layers=tuple(layers), rest=LayerAssign())

    # greedy flip order: largest weighted site error first; deterministic
    # tie-break on (layer, site order). Every flip buys the same modeled
    # throughput loss (EXACT_SITE_COST_S dominates any table delay), so
    # max-error-reduction-per-cost == max-error-reduction.
    order = sorted(((i, s) for i in range(n) for s in SITES),
                   key=lambda t: (-_site_weight(t[0], n) * errs[t[1]],
                                  t[0], SITES.index(t[1])))
    flipped: set = set()
    plan = build(flipped)
    pred = predicted_error(plan, errs)
    it = iter(order)
    while pred > error_budget:
        try:
            flipped.add(next(it))
        except StopIteration:
            break
        plan = build(flipped)
        pred = predicted_error(plan, errs)

    measured: Optional[float] = None
    if verify:
        from repro_torch.device import resolve
        from repro_torch.models import transformer as tf

        dev = resolve(device)
        if params is None:
            params = tf.init_params(cfg, seed=seed, device=dev)
        # batch the envelope probes of every slot x kind through the fleet
        # engine before any library compiles serially off the warm cache
        if explorer is None:
            from repro_torch.plan.numerics import _session

            explorer = _session(dev)  # primed here, compiles the slots
        if plan.uses_interp:
            from repro_torch.api.config import spec_for

            ex = explorer
            pairs = []
            for s in SITES:
                r = slots[s].lookup_bits
                if r is not None:
                    pairs.extend((spec_for(k), r) for k in SITE_KINDS[s])
            if pairs:
                ex.prime_envelopes(pairs)
        cfg_exact = cfg.replace(numerics="exact", plan=None)
        while True:
            measured = _measure_error(cfg.replace(plan=plan), cfg_exact,
                                      params, seed=seed,
                                      prompt_len=prompt_len, device=dev,
                                      explorer=explorer)
            if measured <= error_budget or not plan.uses_interp:
                break
            try:
                flipped.add(next(it))
            except StopIteration:
                plan = plan.degrade_exact()
                continue
            plan = build(flipped)
        pred = predicted_error(plan, errs)

    calib: Optional[dict] = None
    if calibrate:
        from repro_torch.models import transformer as tf

        if params is None:
            params = tf.init_params(cfg, seed=seed, device=device)
        calib = calibrate_slot_latencies(cfg, params, slots,
                                         horizon=horizon, seed=seed,
                                         device=device)

    return PlanReport(
        plan=plan, arch=getattr(cfg, "name", "?"),
        error_budget=float(error_budget), predicted_error=pred,
        measured_error=measured,
        modeled_tokens_per_s=modeled_tokens_per_s(
            plan, slot_delays, horizon=horizon, calibration=calib),
        exact_tokens_per_s=modeled_tokens_per_s(
            NumericsPlan.uniform("exact", n), slot_delays, horizon=horizon,
            calibration=calib),
        site_errors=errs, slot_delays=slot_delays,
        flipped=tuple(sorted(flipped)), calibration=calib)
