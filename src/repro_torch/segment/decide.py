"""Per-depth-group §III decisions over a fixed segmentation (twin of
``repro/segment/decide.py``).

A segmentation's leaves at one depth d all span 2^(B-d) codes, so the group
is a uniform sub-problem: stack one bound row per leaf and run the unchanged
envelopes -> Eqns 9-10 -> minimal-k -> truncation -> Algorithm 1 pipeline
(``core.decision.run_decision``) over those rows through its ``bounds``
hook. With ``bounds`` given, ``run_decision`` reads only the spec's widths
and name, so a group of m leaves of width 2^W runs as a width-only clone of
the spec with ``in_bits = W + ceil_log2(m)`` and ``lookup_bits =
ceil_log2(m)``. The degenerate segmentation (every leaf at depth R) gives
one group whose rows equal ``spec.region_bounds(R)``, so its coefficients
are bit-identical to ``run_decision(spec, R)``.

``device`` is where the ``pallas`` engine computes envelopes (the CUDA
kernels on ``"cuda"``, their plain versions on ``"cpu"``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.decision import DecisionPolicy, run_decision
from repro_torch.core.funcspec import FunctionSpec
from repro_torch.core.table import TableDesign
from repro_torch.segment.design import SegmentedDesign
from repro_torch.segment.tree import Segmentation


def _ceil_log2(n: int) -> int:
    return max(n - 1, 0).bit_length()


def group_bounds(spec: FunctionSpec, seg: Segmentation, leaves: list[int],
                 lo: np.ndarray | None = None, hi: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Stacked (m, 2^W) bound rows of same-depth leaves (one slice per
    leaf's dyadic interval out of the full-domain bound arrays)."""
    if lo is None or hi is None:
        lo, hi = spec.bound_arrays()
    starts = seg.leaf_starts()
    widths = seg.leaf_widths()
    w = int(widths[leaves[0]])
    if any(int(widths[i]) != w for i in leaves):
        raise ValueError("mixed-depth group")
    L = np.stack([lo[starts[i]:starts[i] + w] for i in leaves])
    U = np.stack([hi[starts[i]:starts[i] + w] for i in leaves])
    return L, U


def decide_group(spec: FunctionSpec, seg: Segmentation, leaves: list[int],
                 bounds: tuple[np.ndarray, np.ndarray], *,
                 degree: int | None = None, impl: str | None = None,
                 k_max: int | None = None, engine: str | None = None,
                 policy: DecisionPolicy | None = None, device="cuda"
                 ) -> TableDesign | None:
    """Run the full §III procedure on one depth group; row r of the result
    is leaf ``leaves[r]``'s coefficient triple."""
    m = len(leaves)
    depth = seg.depths[leaves[0]]
    w = spec.in_bits - depth
    lb = _ceil_log2(m)
    pseudo = dataclasses.replace(
        spec, name=f"{spec.name}@d{depth}", in_bits=w + lb)
    out = run_decision(pseudo, lb, degree=degree, impl=impl, k_max=k_max,
                       policy=policy, engine=engine, bounds=bounds,
                       device=device)
    return out[0] if out is not None else None


def decide_segmentation(spec: FunctionSpec, seg: Segmentation, *,
                        degree: int | None = None, impl: str | None = None,
                        k_max: int | None = None, engine: str | None = None,
                        policy: DecisionPolicy | None = None,
                        name: str | None = None, device="cuda"
                        ) -> SegmentedDesign | None:
    """Decide every depth group of ``seg`` and assemble a verified
    :class:`SegmentedDesign`; None if any group has no design."""
    designs, failed = _decide_groups(spec, seg, degree=degree, impl=impl,
                                     k_max=k_max, engine=engine,
                                     policy=policy, device=device)
    if failed is not None:
        return None
    return assemble(spec, seg, designs, name=name)


def _decide_groups(spec: FunctionSpec, seg: Segmentation, *,
                   degree: int | None = None, impl: str | None = None,
                   k_max: int | None = None, engine: str | None = None,
                   policy: DecisionPolicy | None = None,
                   lo: np.ndarray | None = None, hi: np.ndarray | None = None,
                   device="cuda"
                   ) -> tuple[dict[int, TableDesign], int | None]:
    """(depth -> group design, first failing depth or None)."""
    if lo is None or hi is None:
        lo, hi = spec.bound_arrays()
    designs: dict[int, TableDesign] = {}
    for depth, leaves in sorted(seg.depth_groups().items()):
        b = group_bounds(spec, seg, leaves, lo, hi)
        d = decide_group(spec, seg, leaves, b, degree=degree, impl=impl,
                         k_max=k_max, engine=engine, policy=policy,
                         device=device)
        if d is None:
            return designs, depth
        designs[depth] = d
    return designs, None


def assemble(spec: FunctionSpec, seg: Segmentation,
             group_designs: dict[int, TableDesign],
             name: str | None = None) -> SegmentedDesign:
    """Scatter per-group coefficient rows back to leaf order and merge the
    Algorithm-1 storage formats (widest per column across groups); the
    assembled artifact is exhaustively re-verified against the spec."""
    s = seg.n_leaves
    a = np.zeros(s, np.int64)
    b = np.zeros(s, np.int64)
    c = np.zeros(s, np.int64)
    meta_rows: list = [None] * s
    for depth, leaves in seg.depth_groups().items():
        d = group_designs[depth]
        w = spec.in_bits - depth
        for r, i in enumerate(leaves):
            a[i], b[i], c[i] = int(d.a[r]), int(d.b[r]), int(d.c[r])
            meta_rows[i] = (w, d.k, d.sq_trunc, d.lin_trunc, d.degree)

    def widest(col: str):
        metas = [getattr(group_designs[dp], col) for dp in group_designs]
        return max(metas, key=lambda m: (m.width, -m.shift))

    design = SegmentedDesign(
        name=name or f"{spec.name}_S{s}D{seg.max_depth}",
        in_bits=spec.in_bits, out_bits=spec.out_bits, seg=seg,
        a=a, b=b, c=c, leaf_meta=tuple(meta_rows),
        a_meta=widest("a_meta"), b_meta=widest("b_meta"),
        c_meta=widest("c_meta"))
    ok, worst = design.verify(spec)
    if not ok:
        raise AssertionError(f"segmented decision produced an invalid design "
                             f"for {spec.name} ({worst} ULP violation)")
    return design
