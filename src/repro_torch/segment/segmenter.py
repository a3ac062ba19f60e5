"""Greedy dyadic segmenter: split only where the function needs it (twin
of ``repro/segment/segmenter.py``).

1. start from the uniform tree at ``min_depth``;
2. probe each leaf's Eqns 9-10 feasibility (``compute_spaces`` over the
   stacked same-depth rows, one call per depth group) and split every
   infeasible leaf, until all leaves are feasible or sit at ``max_depth``;
3. run the per-depth-group §III decisions (:mod:`repro_torch.segment.
   decide`); if a group fails (no integer design at its shared k), split
   that group's leaves and go back to 2;
4. assemble and exhaustively verify the :class:`SegmentedDesign`.

Splitting a feasible leaf keeps it feasible, so the refinement is monotone
and stops at ``max_depth``, which defaults to the smallest feasible uniform
R: the result never has more resolution anywhere than the uniform design.

``engine`` threads through untouched (``pooled`` serial oracle,
``batched``, ``pallas``: bit-identical designs); ``device`` is where the
``pallas`` engine computes envelopes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.decision import DecisionPolicy
from repro_torch.core.designspace import compute_spaces, regions_feasible
from repro_torch.core.funcspec import FunctionSpec
from repro_torch.segment.decide import _decide_groups, assemble, group_bounds
from repro_torch.segment.design import SegmentedDesign
from repro_torch.segment.tree import Segmentation


def min_uniform_depth(spec: FunctionSpec, *, lo: int = 1,
                      impl: str | None = None, engine: str | None = None,
                      device="cuda") -> int:
    """Smallest R whose uniform 2^R regions all pass Eqns 9-10."""
    for r in range(lo, spec.in_bits):
        ok, _ = regions_feasible(spec, r, impl, engine=engine, device=device)
        if ok:
            return r
    raise ValueError(f"{spec.name}: no feasible uniform R < in_bits")


def _infeasible_leaves(spec: FunctionSpec, seg: Segmentation,
                       lo: np.ndarray, hi: np.ndarray,
                       impl: str | None, engine: str | None,
                       device="cuda") -> list[int]:
    """Leaves failing the Eqns 9-10 existence test, one ``compute_spaces``
    call per depth group."""
    bad: list[int] = []
    for _depth, leaves in sorted(seg.depth_groups().items()):
        L, U = group_bounds(spec, seg, leaves, lo, hi)
        spaces = compute_spaces(L, U, impl, engine, device=device)
        bad.extend(i for i, s in zip(leaves, spaces) if not s.feasible)
    return sorted(bad)


def explore_segmented(spec: FunctionSpec, *, min_depth: int = 2,
                      max_depth: int | None = None,
                      degree: int | None = None, impl: str | None = None,
                      k_max: int | None = None, engine: str | None = None,
                      policy: DecisionPolicy | None = None,
                      name: str | None = None, device="cuda"
                      ) -> SegmentedDesign | None:
    """Grow the cheapest feasible dyadic segmentation and decide it.

    Returns a verified :class:`SegmentedDesign`, or None when even the
    all-``max_depth`` tree admits no integer design under ``k_max``.
    """
    lo, hi = spec.bound_arrays()
    if max_depth is None:
        max_depth = min_uniform_depth(spec, lo=min_depth, impl=impl,
                                      engine=engine, device=device)
    min_depth = min(min_depth, max_depth)
    seg = Segmentation.uniform(spec.in_bits, min_depth)

    # Phase 1: split to Eqns 9-10 feasibility.
    while True:
        bad = _infeasible_leaves(spec, seg, lo, hi, impl, engine, device)
        if not bad:
            break
        splittable = [i for i in bad if seg.depths[i] < max_depth]
        if not splittable:
            return None
        seg = seg.split_many(splittable)

    # Phase 2: per-depth-group decisions; split any group that cannot
    # realize integer coefficients at its shared k.
    while True:
        designs, failed = _decide_groups(spec, seg, degree=degree, impl=impl,
                                         k_max=k_max, engine=engine,
                                         policy=policy, lo=lo, hi=hi,
                                         device=device)
        if failed is None:
            return assemble(spec, seg, designs, name=name)
        splittable = [i for i, d in enumerate(seg.depths)
                      if d == failed and d < max_depth]
        if not splittable:
            return None
        seg = seg.split_many(splittable)
