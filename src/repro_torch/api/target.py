"""Hardware targets: decision-procedure ordering + area/delay estimation.

The paper's §III claim — "targeting alternative hardware technologies simply
requires a modified decision procedure to explore the space" — is made
first-class here. A :class:`Target` bundles exactly the two things a
technology contributes:

  * a :class:`~repro_torch.core.decision.DecisionPolicy` — *how* the complete
    space is walked (which §III steps run, lin-vs-quad preference), and
  * an estimator + objective — *what* a finished design costs in that
    technology's units, used to rank the R-sweep.

The region envelopes (§II Eqns 9-10) are target-independent; the Explorer
computes them once per (spec, R) and every registered target explores the
same cached space. Registering a new technology is a ~20-line subclass —
no changes to the core procedure (DESIGN.md §6).

Twin of ``repro/api/target.py``: the ``asic``, ``fpga-lut`` and
``pallas-tpu`` targets stay as pricing models, so the port's frontiers
reproduce the reference's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Protocol, runtime_checkable

from repro_torch.core import area as area_model
from repro_torch.core.area import AreaDelay
from repro_torch.core.decision import DecisionPolicy
from repro_torch.core.table import TableDesign


@runtime_checkable
class Target(Protocol):
    """Protocol every hardware technology implements."""

    name: str
    policy: DecisionPolicy

    def estimate(self, design: TableDesign) -> AreaDelay:
        """Cost of a finished design in this technology's (area, delay) units."""
        ...

    def objective(self, design: TableDesign, ad: AreaDelay) -> Any:
        """Ranking key over the R-sweep (lower is better; tuples allowed)."""
        ...


_REGISTRY: Dict[str, Target] = {}


def register_target(name: str):
    """Class/instance decorator adding a Target to the global registry.

    Returns the registered *instance*, so the decorated symbol is the same
    object ``get_target(name)`` resolves to and can itself be passed as a
    target."""

    def deco(obj):
        target = obj() if isinstance(obj, type) else obj
        target.name = name
        _REGISTRY[name] = target
        return target

    return deco


def get_target(target: str | Target) -> Target:
    if isinstance(target, str):
        try:
            return _REGISTRY[target]
        except KeyError:
            raise KeyError(
                f"unknown target {target!r}; registered: {sorted(_REGISTRY)}"
            ) from None
    if isinstance(target, type):  # an unregistered Target class: instantiate
        target = target()
    if not hasattr(target, "name"):  # unregistered ad-hoc target: default it
        target.name = type(target).__name__
    return target


def list_targets() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-in technologies
# ---------------------------------------------------------------------------

@register_target("asic")
class AsicTarget:
    """The paper's target: standard-cell ASIC, square path on the critical
    path. Ordering is §III verbatim (max truncations, then Algorithm 1);
    cost is the bit-operation proxy of core.area (DESIGN.md §7.1)."""

    name = "asic"
    policy = DecisionPolicy()

    def estimate(self, design: TableDesign) -> AreaDelay:
        return area_model.estimate(design)

    def objective(self, design: TableDesign, ad: AreaDelay) -> float:
        return ad.area * ad.delay

    def decoder_estimate(self, n_leaves: int, depth: int) -> AreaDelay:
        """Segment-index decoder: a 2^depth x ceil(log2 S)-bit ROM feeding
        the coefficient LUT address — same cell model as the main ROM plus
        one extra serial lookup level on the critical path."""
        idx_bits = max(n_leaves - 1, 1).bit_length()
        area = 0.25 * (1 << depth) * idx_bits
        delay = 1.0 + 0.35 * depth + 0.2 * math.log2(max(idx_bits, 2.0))
        return AreaDelay(area=area, delay=delay)


@register_target("fpga-lut")
class FpgaLutTarget:
    """LUT-fabric FPGA: everything — ROM and arithmetic — is 6-input LUTs.

    Ordering keeps the truncation steps (fewer partial products = fewer
    logic LUTs), but the ranking is LUT-count-weighted: total LUT count
    first, routed depth only as a tie-breaker, because fabric frequency is
    routing-dominated and far less sensitive to the datapath than an ASIC's.
    """

    name = "fpga-lut"
    policy = DecisionPolicy()

    def estimate(self, design: TableDesign) -> AreaDelay:
        r, w = design.lookup_bits, design.eval_bits
        wa, wb, wc = design.lut_widths
        s = max(w - design.sq_trunc, 0)
        lb = max(w - design.lin_trunc, 0)
        # ROM as distributed LUTRAM: one 6-LUT holds 64x1 bits. Segmented
        # designs carry their (smaller) stored row count in ``rows``.
        rows = int(getattr(design, "rows", 0) or (1 << r))
        rom_luts = (wa + wb + wc) * max(rows // 64, 1)
        # soft multipliers: ~half a LUT per partial-product bit.
        mul_luts = 0.5 * wb * lb
        if design.degree == 2 and s > 0:
            mul_luts += 0.25 * s * s + 0.5 * wa * (2 * s)  # squarer + a-mul
        acc_w = max(wc, wa + 2 * s, wb + lb) + 2
        add_luts = float(acc_w)  # carry chain
        area = rom_luts + mul_luts + add_luts
        # depth in LUT levels (logic only; routing folded into the constant)
        levels = 1.0 + math.log2(max(acc_w, 2.0)) / 2.0
        if design.degree == 2 and s > 0:
            levels += math.log2(max(2 * s, 2.0)) / 2.0
        return AreaDelay(area=area, delay=levels)

    def objective(self, design: TableDesign, ad: AreaDelay) -> tuple:
        return (round(ad.area), ad.delay)

    def decoder_estimate(self, n_leaves: int, depth: int) -> AreaDelay:
        """Segment-index table as LUTRAM plus one extra LUT level of
        address indirection before the coefficient read."""
        idx_bits = max(n_leaves - 1, 1).bit_length()
        luts = idx_bits * max((1 << depth) // 64, 1)
        return AreaDelay(area=float(luts), delay=1.0)


@register_target("pallas-tpu")
class PallasTpuTarget:
    """This repo's serving target: the table evaluated inside Pallas kernels.

    Input truncation buys nothing on a vector unit (lane width is fixed), so
    the policy skips §III steps 2-3 and goes straight to Algorithm 1. Cost is
    what actually constrains the kernels: VMEM footprint of the staged
    coefficient matrix (area axis) and the widest integer product the
    evaluation needs (delay axis) — products past 31 bits force the int64
    jnp fallback path, which the objective penalizes first (DESIGN.md §7.5).
    """

    name = "pallas-tpu"
    policy = DecisionPolicy(maximize_sq_trunc=False, maximize_lin_trunc=False)

    # A segmented slot's packed seg table lives inside the coefficient ROM
    # rows (ROM v2), so the ``rows`` override below already pays its VMEM.
    seg_table_in_rom = True

    def estimate(self, design: TableDesign) -> AreaDelay:
        rows = int(getattr(design, "rows", 0) or (1 << design.lookup_bits))
        wa, wb, _ = design.lut_widths
        w = design.eval_bits
        s = max(w - design.sq_trunc, 0)
        lb = max(w - design.lin_trunc, 0)
        int32_ok = all(m.width <= 31 for m in
                       (design.a_meta, design.b_meta, design.c_meta))
        vmem = rows * 3 * (4 if int32_ok else 8)  # packed coeff bytes
        mult_bits = max(wa + 2 * s, wb + lb, 1)
        return AreaDelay(area=float(vmem), delay=float(mult_bits))

    def objective(self, design: TableDesign, ad: AreaDelay) -> tuple:
        # VMEM bytes first (already 2x when not int32-packable), then width
        return (ad.area, ad.delay)

    def decoder_estimate(self, n_leaves: int, depth: int) -> AreaDelay:
        """VMEM is already counted via ``rows`` (the packed table rides in
        the slot); the marginal cost is the extra one-hot gather contraction,
        whose width scales with the 2^depth cell count."""
        return AreaDelay(area=0.0, delay=float(depth))
