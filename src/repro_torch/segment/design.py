"""SegmentedDesign: a verified non-uniform piecewise-polynomial artifact
(twin of ``repro/segment/design.py``).

The non-uniform counterpart of :class:`repro_torch.core.table.TableDesign`:
one (a, b, c) coefficient row per leaf of a :class:`Segmentation`, plus the
per-leaf datapath constants (eval_bits, k, truncations, degree) that the
uniform design keeps as scalars. ``eval_int`` is the exact int64 oracle of
the whole artifact, the one the segmented datapath of every kernel is held
against; :meth:`InterpLibrary.from_designs` takes a ``SegmentedDesign``
into a ROM-v2 slot through ``seg_depth`` / ``leaf_meta`` /
``packed_coeffs()``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.funcspec import FunctionSpec
from repro_torch.core.table import CoeffMeta
from repro_torch.segment.tree import Segmentation


@dataclasses.dataclass
class SegmentedDesign:
    """A concrete, verified non-uniform piecewise-polynomial implementation.

    ``leaf_meta[i]`` is leaf i's (eval_bits, k, sq_trunc, lin_trunc, degree)
    row. The scalar ``k`` / truncation attributes mirror leaf 0 (what
    ``FuncMeta``'s uniform fields record); per-leaf values always come from
    ``leaf_meta``.
    """

    name: str
    in_bits: int
    out_bits: int
    seg: Segmentation
    a: np.ndarray  # (S,) int64, one row per leaf, left to right
    b: np.ndarray
    c: np.ndarray
    leaf_meta: tuple[tuple[int, int, int, int, int], ...]
    a_meta: CoeffMeta  # merged storage formats (widest over depth groups)
    b_meta: CoeffMeta
    c_meta: CoeffMeta

    def __post_init__(self):
        s = self.seg.n_leaves
        if not len(self.a) == len(self.b) == len(self.c) == s:
            raise ValueError(f"{len(self.a)} coefficient rows for {s} leaves")
        if len(self.leaf_meta) != s:
            raise ValueError(f"{len(self.leaf_meta)} leaf rows for {s} leaves")
        for i, (eb, *_rest) in enumerate(self.leaf_meta):
            if eb != self.in_bits - self.seg.depths[i]:
                raise ValueError(f"leaf {i}: eval_bits {eb} != B - d")

    # -- representative scalars (FuncMeta's uniform fields) ----------------
    @property
    def seg_depth(self) -> int:
        return self.seg.max_depth

    @property
    def lookup_bits(self) -> int:
        """The segment-index table depth D: what the top bits address."""
        return self.seg.max_depth

    @property
    def eval_bits(self) -> int:
        """Widest per-leaf evaluation width."""
        return max(m[0] for m in self.leaf_meta)

    @property
    def k(self) -> int:
        return self.leaf_meta[0][1]

    @property
    def sq_trunc(self) -> int:
        return self.leaf_meta[0][2]

    @property
    def lin_trunc(self) -> int:
        return self.leaf_meta[0][3]

    @property
    def degree(self) -> int:
        """2 if any leaf is quadratic (the squarer must exist)."""
        return max(m[4] for m in self.leaf_meta)

    @property
    def n_leaves(self) -> int:
        return self.seg.n_leaves

    @property
    def lut_widths(self) -> tuple[int, int, int]:
        return (self.a_meta.width, self.b_meta.width, self.c_meta.width)

    @property
    def rows_used(self) -> int:
        """ROM-v2 slot rows: per-leaf coeffs + the packed seg table."""
        return self.n_leaves + ((1 << self.seg_depth) + 2) // 3

    rows = rows_used  # what the targets' cost models read

    # -- evaluation / verification ----------------------------------------
    def eval_int(self, codes: np.ndarray) -> np.ndarray:
        """Exact int64 oracle of the segment-index datapath: cell = top D
        bits -> seg table -> leaf; x = the code's low eval_bits(leaf) bits;
        then the leaf's Figure-1 tail."""
        codes = np.asarray(codes, dtype=np.int64)
        cell = codes >> (self.in_bits - self.seg_depth)
        leaf = self.seg.seg_table().astype(np.int64)[cell]
        meta = np.asarray(self.leaf_meta, np.int64)[leaf]
        eb, k, sq, lin, deg = (meta[..., i] for i in range(5))
        x = codes & ((np.int64(1) << eb) - 1)
        xs = (x >> sq) << sq
        xl = (x >> lin) << lin
        sq_term = np.where(deg == 2, self.a[leaf] * xs * xs, 0)
        acc = sq_term + self.b[leaf] * xl + self.c[leaf]
        return acc >> k

    def verify(self, spec: FunctionSpec) -> tuple[bool, int]:
        """Exhaustive int64 sweep over every input code. Returns (ok, worst
        violation in ULPs)."""
        lo, hi = spec.bound_arrays()
        y = self.eval_int(np.arange(1 << self.in_bits, dtype=np.int64))
        worst = int(max((lo - y).max(), (y - hi).max()))
        return worst <= 0, max(worst, 0)

    def max_error_ulp(self, spec: FunctionSpec) -> float:
        if spec.value is None:
            raise ValueError("spec has no real-valued target")
        codes = np.arange(1 << self.in_bits, dtype=np.int64)
        y = self.eval_int(codes).astype(np.float64)
        return float(np.abs(y - spec.value(codes)).max())

    # -- ROM packing -------------------------------------------------------
    @property
    def fits_int32(self) -> bool:
        mat = np.stack([self.a, self.b, self.c], axis=1)
        return bool(np.abs(mat).max() < 2**31)

    def packed_coeffs(self) -> np.ndarray:
        """(rows_used, 3) int32 ROM-v2 slot: per-leaf coefficient rows, then
        the packed segment-index table."""
        mat = np.stack([self.a, self.b, self.c], axis=1)
        if np.abs(mat).max() >= 2**31:
            raise ValueError(f"{self.name}: coefficients exceed int32")
        return np.concatenate(
            [mat.astype(np.int32), self.seg.packed_table()], axis=0)
