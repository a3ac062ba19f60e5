"""Cost estimation for segmented designs against the registered targets
(twin of ``repro/segment/cost.py``).

A :class:`SegmentedDesign` is costed as the uniform model over a
conservative scalar view (widest datapath over the leaves, stored row count
instead of the 2^R address span) plus the target's segment-index decoder
(``Target.decoder_estimate``). Targets that pack the seg table into the
coefficient ROM (``seg_table_in_rom``, ROM v2) are charged the full
``rows_used`` as ROM; the others store only the per-leaf rows there and pay
for the table inside ``decoder_estimate``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.area import AreaDelay
from repro_torch.core.table import CoeffMeta
from repro_torch.segment.design import SegmentedDesign


@dataclasses.dataclass(frozen=True)
class _CostView:
    """Stand-in for TableDesign in the uniform cost models: the widest
    per-leaf datapath and an explicit stored row count."""

    lookup_bits: int
    eval_bits: int
    degree: int
    sq_trunc: int
    lin_trunc: int
    a_meta: CoeffMeta
    b_meta: CoeffMeta
    c_meta: CoeffMeta
    rows: int

    @property
    def lut_widths(self) -> tuple[int, int, int]:
        return (self.a_meta.width, self.b_meta.width, self.c_meta.width)


def cost_view(design: SegmentedDesign, rows: int | None = None) -> _CostView:
    metas = design.leaf_meta
    return _CostView(
        lookup_bits=design.seg_depth,
        eval_bits=max(m[0] for m in metas),
        degree=max(m[4] for m in metas),
        sq_trunc=min(m[2] for m in metas),
        lin_trunc=min(m[3] for m in metas),
        a_meta=design.a_meta, b_meta=design.b_meta, c_meta=design.c_meta,
        rows=int(rows if rows is not None else design.n_leaves))


def estimate_segmented(design: SegmentedDesign, target) -> AreaDelay:
    """(area, delay) of a segmented design under ``target``: the uniform
    model over the conservative view plus the segment-index decoder."""
    from repro_torch.api.target import get_target

    t = get_target(target)
    packed = bool(getattr(t, "seg_table_in_rom", False))
    view = cost_view(design, rows=design.rows_used if packed
                     else design.n_leaves)
    base = t.estimate(view)
    dec = t.decoder_estimate(design.n_leaves, design.seg_depth) \
        if hasattr(t, "decoder_estimate") else AreaDelay(0.0, 0.0)
    return AreaDelay(area=base.area + dec.area, delay=base.delay + dec.delay)
