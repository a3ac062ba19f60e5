"""Area/delay proxy model (stands in for Design Compiler + TSMC 7nm).

The paper ranks candidate designs by synthesized area x delay; this container
has no synthesis flow, so the decision layer ranks with an explicit
bit-operation model instead (DESIGN.md §7.1). Units are arbitrary
("NAND2-equivalents" for area, "FO4-ish" for delay) — only *relative* order
matters, exactly how §III uses the target-technology cost to steer the
exploration. The model follows Figure 1's architecture:

    LUT[r] -> (a, b, c);   square path:  x -> x_i^2 -> a * x_i^2
    accumulate a*x_i^2 + b*x_j + c, then >> k.

Twin of ``repro/core/area.py``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.table import TableDesign


def _log2(v: float) -> float:
    return math.log2(max(v, 2.0))


@dataclasses.dataclass(frozen=True)
class AreaDelay:
    area: float
    delay: float

    @property
    def product(self) -> float:
        return self.area * self.delay


def estimate(design: TableDesign) -> AreaDelay:
    r = design.lookup_bits
    w = design.eval_bits
    wa, wb, wc = design.lut_widths
    s = max(w - design.sq_trunc, 0)  # squarer input bits
    lb = max(w - design.lin_trunc, 0)  # linear-term input bits
    acc_w = max(wc, wa + 2 * s, wb + lb) + 2  # accumulator width

    # --- area ---------------------------------------------------------------
    # Non-uniform designs store fewer rows than their address span (the
    # segment decoder is costed separately by the target); uniform designs
    # have no ``rows`` attribute and keep the 2^r ROM.
    rows = int(getattr(design, "rows", 0) or (1 << r))
    lut_bits = rows * (wa + wb + wc)
    area = 0.25 * lut_bits  # ROM cell ~ 1/4 logic cell
    if design.degree == 2 and s > 0:
        area += 0.5 * s * s  # dedicated squarer (folded Booth array)
        area += 1.0 * wa * (2 * s)  # a * x^2 multiplier array
    area += 1.0 * wb * lb  # b * x array
    area += 2.0 * acc_w  # carry-propagate adder + rounding

    # --- delay (critical path; paper §III assumes the square path) -----------
    d_lut = 1.0 + 0.35 * r + 0.2 * _log2(wa + wb + wc)
    d_add = 0.5 * _log2(acc_w)
    if design.degree == 2 and s > 0:
        d_sq = 0.8 * _log2(s)
        d_mul = 0.8 * _log2(wa) + 0.8 * _log2(2 * s)
        delay = max(d_sq + d_mul, d_lut) + d_add
    else:
        d_mul = 0.8 * _log2(wb) + 0.8 * _log2(lb)
        delay = max(d_mul, d_lut) + d_add
    return AreaDelay(area=area, delay=delay)
