"""Hierarchical power-of-two segmentations (twin of
``repro/segment/tree.py``).

The paper's layout is *uniform*: the top R input bits select one of 2^R
equal regions. A dyadic prefix tree keeps the power-of-two address decode
but lets region widths vary: every leaf is an aligned interval
``[p * 2^(B-d), (p+1) * 2^(B-d))`` at some depth ``d``, and the region index
comes from a 2^D-entry table addressed by the top ``D = max(d)`` input bits.
That table is what the ROM-v2 slot layout stores and what the segmented
branch of the shared datapath (``csrc/datapath.cuh`` ``lut_rom``) reads.

:class:`Segmentation` is the pure combinatorial object; bounds,
coefficients and costs live in the sibling modules.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Segmentation:
    """Leaves of a dyadic prefix tree tiling ``[0, 2^in_bits)``.

    ``depths[i]`` is the depth of leaf ``i`` (left to right); leaf i covers
    ``2^(in_bits - depths[i])`` codes. Each leaf is checked at construction
    to be aligned to its own width, and the widths to sum to the domain.
    """

    in_bits: int
    depths: tuple[int, ...]

    def __post_init__(self):
        b = self.in_bits
        if b <= 0:
            raise ValueError(f"in_bits must be positive, got {b}")
        if not self.depths:
            raise ValueError("segmentation needs at least one leaf")
        pos = 0
        for i, d in enumerate(self.depths):
            if not 0 <= d <= b:
                raise ValueError(f"leaf {i}: depth {d} outside [0, {b}]")
            width = 1 << (b - d)
            if pos % width:
                raise ValueError(
                    f"leaf {i}: start {pos} not aligned to width {width}")
            pos += width
        if pos != 1 << b:
            raise ValueError(
                f"leaves cover [0, {pos}), domain is [0, {1 << b})")

    # -- constructors ------------------------------------------------------
    @classmethod
    def uniform(cls, in_bits: int, lookup_bits: int) -> "Segmentation":
        """The degenerate segmentation: 2^R equal leaves at depth R."""
        return cls(in_bits, (lookup_bits,) * (1 << lookup_bits))

    def split(self, leaf: int) -> "Segmentation":
        """Replace leaf ``leaf`` by its two children (depth + 1)."""
        d = self.depths[leaf]
        if d >= self.in_bits:
            raise ValueError(f"leaf {leaf} already at max depth {d}")
        return Segmentation(
            self.in_bits,
            self.depths[:leaf] + (d + 1, d + 1) + self.depths[leaf + 1:])

    def split_many(self, leaves) -> "Segmentation":
        """Split several leaves at once (indices into the current tree)."""
        out = list(self.depths)
        for i in sorted(set(leaves), reverse=True):
            d = out[i]
            if d >= self.in_bits:
                raise ValueError(f"leaf {i} already at max depth {d}")
            out[i:i + 1] = [d + 1, d + 1]
        return Segmentation(self.in_bits, tuple(out))

    # -- structure ---------------------------------------------------------
    @property
    def n_leaves(self) -> int:
        return len(self.depths)

    @property
    def max_depth(self) -> int:
        """D: the segment-index table is addressed by the top D input bits."""
        return max(self.depths)

    @property
    def is_uniform(self) -> bool:
        return len(set(self.depths)) == 1

    def leaf_widths(self) -> np.ndarray:
        return np.array([1 << (self.in_bits - d) for d in self.depths],
                        np.int64)

    def leaf_starts(self) -> np.ndarray:
        """(S,) int64 first code of each leaf."""
        widths = self.leaf_widths()
        starts = np.zeros(len(widths), np.int64)
        np.cumsum(widths[:-1], out=starts[1:])
        return starts

    def seg_table(self) -> np.ndarray:
        """(2^D,) int32 leaf index per cell of the top-D-bit address space
        (the ROM-v2 segment-index table); a leaf at depth d < D owns
        ``2^(D - d)`` consecutive cells."""
        d_max = self.max_depth
        out = np.empty(1 << d_max, np.int32)
        pos = 0
        for i, d in enumerate(self.depths):
            n = 1 << (d_max - d)
            out[pos:pos + n] = i
            pos += n
        return out

    def packed_table(self) -> np.ndarray:
        """The seg table packed 3 int32 entries per ROM row,
        ``(ceil(2^D / 3), 3)``: the rows after the per-leaf coefficients in
        a ROM-v2 slot."""
        tab = self.seg_table()
        n_rows = (len(tab) + 2) // 3
        out = np.zeros(n_rows * 3, np.int32)
        out[: len(tab)] = tab
        return out.reshape(n_rows, 3)

    def depth_groups(self) -> dict[int, list[int]]:
        """depth -> leaf indices at that depth (insertion-ordered)."""
        groups: dict[int, list[int]] = {}
        for i, d in enumerate(self.depths):
            groups.setdefault(d, []).append(i)
        return groups
