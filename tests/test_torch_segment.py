"""Non-uniform segmentation in the port (``repro_torch.segment`` and
``Explorer.compile_segmented``) against the reference's ``repro.segment``
on the same specs, and the reference's own invariants inside the port.

Everything here is integer or combinatorial, so every comparison is exact:
segment tables, per-leaf coefficients and datapath rows, storage formats,
``eval_int`` over every code, cost estimates (the same float expressions on
the same integers), and the compiled library's ROM bytes (``rom_sha``).
Specs are 8 bits (10 for the degenerate-tree check, as the reference's
``tests/segment``), except the full default manifest at 12 bits.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.api.config import spec_for as jax_spec_for
from repro.api.target import get_target as jax_get_target
from repro.segment import Segmentation as JaxSegmentation
from repro.segment import decide_segmentation as jax_decide_segmentation
from repro.segment import estimate_segmented as jax_estimate_segmented
from repro.segment import explore_segmented as jax_explore_segmented
from repro.segment import min_uniform_depth as jax_min_uniform_depth
from repro_torch.api import Explorer, ExploreConfig, spec_for
from repro_torch.core.decision import run_decision
from repro_torch.segment import (Segmentation, SegmentedDesign,
                                 decide_segmentation, estimate_segmented,
                                 explore_segmented, min_uniform_depth)
from repro_torch.segment.decide import _decide_groups

SEG_ROM_SHA = "f775a828748d4ea9"
# the default manifest segmented (kind: seg depth D, leaves, rows used)
SEG_SHAPES = {"exp2neg": (2, 4, 6), "gelu": (5, 10, 21), "recip": (3, 7, 10),
              "rsqrt": (4, 9, 15), "sigmoid": (5, 18, 29),
              "silu": (4, 10, 16), "softplus": (4, 8, 14),
              "tanh": (6, 20, 42)}
KINDS8 = ("tanh", "sigmoid", "gelu", "silu", "softplus", "recip", "rsqrt",
          "exp2neg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(cls):
    u = cls.uniform(8, 3)
    return {
        "uniform": u,
        "split": u.split(0).split(0).split(9),
        "split_many": u.split_many([0, 3, 7]).split_many([0, 1, 4]),
        "root": cls(8, (0,)),
        "deep": cls(8, (1, 2, 3, 8, 8) + (7,) + (6, 5, 4)),
    }


@pytest.mark.parametrize("name", sorted(_trees(Segmentation)))
def test_segmentation_tables_equal_reference(name):
    got, want = _trees(Segmentation)[name], _trees(JaxSegmentation)[name]
    assert got.depths == want.depths
    assert (got.n_leaves, got.max_depth, got.is_uniform) == \
        (want.n_leaves, want.max_depth, want.is_uniform)
    for fn in ("leaf_starts", "leaf_widths", "seg_table", "packed_table"):
        a, b = getattr(got, fn)(), getattr(want, fn)()
        assert a.dtype == b.dtype and a.shape == b.shape, fn
        np.testing.assert_array_equal(a, b)
    assert got.depth_groups() == want.depth_groups()


@pytest.mark.parametrize("depths", [(1, 2), (2, 1, 1), (0, 1), (9,) * 512])
def test_invalid_trees_refused_like_reference(depths):
    with pytest.raises(ValueError):
        JaxSegmentation(8, depths)
    with pytest.raises(ValueError):
        Segmentation(8, depths)


@pytest.mark.parametrize("kind", ["tanh", "sigmoid", "gelu", "silu"])
def test_degenerate_tree_equals_uniform_bitwise(kind):
    """A tree of 2^R leaves at depth R decides to the uniform design at R,
    bitwise: coefficients, per-leaf datapath rows, storage formats and
    eval_int on every one of the 1024 codes; and to the reference's."""
    spec = spec_for(kind, 10)
    r = min_uniform_depth(spec, engine="batched")
    assert r == jax_min_uniform_depth(jax_spec_for(kind, 10),
                                      engine="batched")
    uni, _ = run_decision(spec, r, engine="batched", device="cpu")
    sd = decide_segmentation(spec, Segmentation.uniform(10, r),
                             engine="batched", device="cpu")
    jsd = jax_decide_segmentation(jax_spec_for(kind, 10),
                                  JaxSegmentation.uniform(10, r),
                                  engine="batched")
    for d in (uni, jsd):
        np.testing.assert_array_equal(sd.a, d.a)
        np.testing.assert_array_equal(sd.b, d.b)
        np.testing.assert_array_equal(sd.c, d.c)
    w = 10 - r
    assert all(m == (w, uni.k, uni.sq_trunc, uni.lin_trunc, uni.degree)
               for m in sd.leaf_meta)
    assert sd.leaf_meta == jsd.leaf_meta
    assert (sd.a_meta, sd.b_meta, sd.c_meta) == \
        (uni.a_meta, uni.b_meta, uni.c_meta)
    codes = np.arange(1 << 10, dtype=np.int64)
    np.testing.assert_array_equal(sd.eval_int(codes), uni.eval_int(codes))
    assert sd.verify(spec) == (True, 0)


def _same_design(sd: SegmentedDesign, jsd) -> None:
    assert sd.name == jsd.name
    assert sd.seg.depths == jsd.seg.depths
    for col in "abc":
        np.testing.assert_array_equal(getattr(sd, col), getattr(jsd, col))
    assert sd.leaf_meta == jsd.leaf_meta
    for col in ("a_meta", "b_meta", "c_meta"):
        assert getattr(sd, col).to_dict() == vars(getattr(jsd, col))
    for prop in ("seg_depth", "lookup_bits", "eval_bits", "k", "sq_trunc",
                 "lin_trunc", "degree", "n_leaves", "rows_used",
                 "lut_widths", "fits_int32"):
        assert getattr(sd, prop) == getattr(jsd, prop), prop
    np.testing.assert_array_equal(sd.packed_coeffs(), jsd.packed_coeffs())
    codes = np.arange(1 << sd.in_bits, dtype=np.int64)
    np.testing.assert_array_equal(sd.eval_int(codes), jsd.eval_int(codes))


@pytest.mark.parametrize("engine", ["batched", "pallas"])
@pytest.mark.parametrize("kind", KINDS8)
def test_explore_segmented_matches_reference(kind, engine):
    """The greedy segmenter at 8 bits under the port's batched engine and
    its pallas engine (the envelope kernels' plain versions on the CPU)
    reaches the reference's tree, coefficients and leaf rows."""
    spec, jspec = spec_for(kind, 8), jax_spec_for(kind, 8)
    r = min_uniform_depth(spec, engine=engine, device="cpu")
    assert r == jax_min_uniform_depth(jspec, engine="batched")
    sd = explore_segmented(spec, max_depth=r, engine=engine, device="cpu")
    jsd = jax_explore_segmented(jspec, max_depth=r, engine="batched")
    assert (sd is None) == (jsd is None)
    _same_design(sd, jsd)
    assert sd.verify(spec) == (True, 0)
    assert sd.max_error_ulp(spec) == jsd.max_error_ulp(jspec)


@pytest.mark.parametrize("engine", ["pooled", "pallas"])
def test_group_decisions_engine_invariant(engine):
    """pooled (serial oracle) and pallas engines decide the same groups as
    the batched engine, inside the port."""
    spec = spec_for("tanh", 10)
    r = min_uniform_depth(spec, engine="batched")
    seg = Segmentation.uniform(10, r).split(0).split(0)
    want, f0 = _decide_groups(spec, seg, engine="batched", device="cpu")
    got, f1 = _decide_groups(spec, seg, engine=engine, device="cpu")
    assert f0 == f1 and sorted(want) == sorted(got)
    for depth in want:
        assert got[depth].to_dict() == want[depth].to_dict()


@pytest.mark.parametrize("target", ["asic", "fpga-lut", "pallas-tpu"])
def test_estimate_segmented_matches_reference(target):
    spec = spec_for("sigmoid", 8)
    sd = explore_segmented(spec, max_depth=5, engine="batched", device="cpu")
    jsd = jax_explore_segmented(jax_spec_for("sigmoid", 8), max_depth=5,
                                engine="batched")
    got = estimate_segmented(sd, target)
    want = jax_estimate_segmented(jsd, jax_get_target(target))
    assert (got.area, got.delay) == (want.area, want.delay)
    assert got.area >= 0 and got.delay > 0


def test_explore_respects_max_depth_and_saves_rows():
    spec = spec_for("tanh", 10)
    sd = explore_segmented(spec, max_depth=4, engine="batched", device="cpu")
    assert sd is None or sd.seg_depth <= 4
    r = min_uniform_depth(spec, engine="batched")
    sd = explore_segmented(spec, max_depth=r, engine="batched", device="cpu")
    assert sd.rows_used < 1 << r and sd.seg_depth <= r


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The port's default manifest through ``compile_segmented`` on the CPU
    (the vendored uniform tables warm a fresh cache, as the generator
    would write them)."""
    cache = tmp_path_factory.mktemp("tables")
    ex = Explorer(ExploreConfig(device="cpu", cache_dir=str(cache)))
    return ex.compile_segmented(), ex


def test_compile_segmented_rom_sha(compiled):
    lib, _ = compiled
    assert lib.rom_sha() == SEG_ROM_SHA == lib.sealed_sha
    assert tuple(lib.coeffs.shape) == (8, 42, 3)
    assert sum(m.rows_used for m in lib.metas) == 153
    assert lib.manifest()["version"] == 2
    assert set(lib.segmented_kinds) == set(SEG_SHAPES)
    for m in lib.metas:
        assert (m.seg_depth, len(m.seg_meta), m.rows_used) == \
            SEG_SHAPES[m.kind], m.kind
        assert m.lookup_bits == m.seg_depth
    walk, dp = lib.walk_rows()
    assert tuple(walk.shape) == (8, 5) and tuple(dp.shape) == (86, 5)
    assert walk.dtype == dp.dtype == torch.int32


def test_compile_segmented_subset_keeps_uniform_slots(compiled):
    """``segment=`` limits the segmenter to the named kinds; the others keep
    their uniform slot and the one library serves both layouts."""
    _, ex = compiled
    lib = ex.compile_segmented(["tanh", "recip", "silu"], segment=["tanh"])
    assert lib.segmented_kinds == ("tanh",)
    assert tuple(lib.coeffs.shape) == (3, 64, 3)
    for kind in ("recip", "silu"):
        uni = ex.get_table(kind)
        np.testing.assert_array_equal(
            lib.coeffs[lib.func_id(kind), :64].numpy(), uni.packed_coeffs())
        assert lib.meta(kind).seg_depth == 0
