"""``segment.tree.Segmentation`` of the port against the reference (twins of
``tests/segment/test_tree.py``): construction guards, splitting, the
seg-index table and its ROM-v2 packing, each result equal to the
reference's on the same tree and each refusal raised by both with the
reference's message."""
from __future__ import annotations

import numpy as np
import pytest

from repro.segment import Segmentation as JaxSegmentation
from repro_torch.segment import Segmentation


def _same(seg, jseg):
    """Every derived table of a tree equals the reference's."""
    assert seg.depths == jseg.depths and seg.in_bits == jseg.in_bits
    assert (seg.n_leaves, seg.max_depth, seg.is_uniform) == (
        jseg.n_leaves, jseg.max_depth, jseg.is_uniform)
    for name in ("leaf_widths", "leaf_starts", "seg_table", "packed_table"):
        got, want = getattr(seg, name)(), getattr(jseg, name)()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert seg.depth_groups() == jseg.depth_groups()


def test_uniform_constructor_is_equal_depth_tiling():
    seg = Segmentation.uniform(8, 3)
    _same(seg, JaxSegmentation.uniform(8, 3))
    assert seg.n_leaves == 8 and seg.max_depth == 3 and seg.is_uniform
    assert np.array_equal(seg.leaf_widths(), np.full(8, 32))
    assert np.array_equal(seg.seg_table(), np.arange(8))


@pytest.mark.parametrize("args,match", [
    ((4, (1,)), "cover"),  # half the domain
    ((4, (1, 1, 1)), "cover"),  # 150% of the domain
    ((4, (2, 1, 2, 2)), "aligned"),  # depth-1 leaf starting at 1/4
    ((4, (0, 5)), "depth"),  # depth past in_bits
    ((4, ()), "at least one leaf"),
    ((0, (0,)), "positive")])
def test_invalid_tilings_rejected(args, match):
    with pytest.raises(ValueError, match=match) as got:
        Segmentation(*args)
    with pytest.raises(ValueError, match=match) as want:
        JaxSegmentation(*args)
    assert str(got.value) == str(want.value)


def test_split_refines_one_leaf():
    seg, jseg = Segmentation.uniform(6, 2), JaxSegmentation.uniform(6, 2)
    s2 = seg.split(1)
    _same(s2, jseg.split(1))
    assert s2.depths == (2, 3, 3, 2, 2)
    assert np.array_equal(s2.leaf_starts(), [0, 16, 24, 32, 48])
    for cls in (Segmentation, JaxSegmentation):
        with pytest.raises(ValueError, match="max depth"):
            cls(4, (0,)).split(0).split(0).split(0).split(0).split(0)


def test_split_many_matches_sequential_splits():
    seg, jseg = Segmentation.uniform(6, 2), JaxSegmentation.uniform(6, 2)
    for idx in ([0, 2], [3, 3], [1, 0, 3]):
        _same(seg.split_many(idx), jseg.split_many(idx))
    assert seg.split_many([0, 2]).depths == seg.split(2).split(0).depths
    assert seg.split_many([3, 3]).depths == seg.split(3).depths


def test_seg_table_assigns_cells_by_depth():
    seg = Segmentation(4, (1, 2, 2))
    _same(seg, JaxSegmentation(4, (1, 2, 2)))
    assert np.array_equal(seg.seg_table(), [0, 0, 1, 2])
    assert seg.depth_groups() == {1: [0], 2: [1, 2]}


def test_packed_table_pads_to_rom_rows():
    seg = Segmentation(4, (1, 2, 2))  # 4 cells -> 2 rows of 3
    packed = seg.packed_table()
    np.testing.assert_array_equal(packed,
                                  JaxSegmentation(4, (1, 2, 2)).packed_table())
    assert packed.shape == (2, 3) and packed.dtype == np.int32
    assert np.array_equal(packed.reshape(-1)[:4], seg.seg_table())
    assert np.all(packed.reshape(-1)[4:] == 0)


def test_random_trees_equal_reference():
    """Seeded random refinements: every derived table equals the
    reference's after each split."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        bits = int(rng.integers(3, 10))
        seg = Segmentation.uniform(bits, int(rng.integers(0, 3)))
        jseg = JaxSegmentation.uniform(bits, seg.max_depth)
        for _ in range(int(rng.integers(1, 6))):
            free = [i for i, d in enumerate(seg.depths) if d < bits]
            if not free:
                break
            idx = sorted({int(i) for i in rng.choice(free, min(2, len(free)))})
            seg, jseg = seg.split_many(idx), jseg.split_many(idx)
            _same(seg, jseg)
