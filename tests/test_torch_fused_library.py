"""The fused library-bound ops, the per-table flash attention and the ROM
walk's rows of the port against the reference, on the CPU (the plain
versions of the CUDA kernels): twins of the tests in
``tests/kernels/test_fused_library.py``, ``tests/kernels/test_flashattn.py``
and ``tests/kernels/test_walk_eval.py`` that no other port test holds.

Tolerances are the reference tests' own: the fused composites against the
glue within a table ulp (softmax atol 2e-3, rmsnorm 3e-3), the flash
attention against its oracle at rtol 5e-2 / atol 5e-3 and against exact
softmax attention within 2.5e-2; the port against the reference within
``softmax_ulp_bound()`` (softmax) or, for the unchunked attention oracles,
``2 * softmax_ulp_bound() * max|v|``. Grouped against expanded
K/V and the fused backend against the library ops are bitwise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.config import spec_for as jax_spec_for
from repro.api.library import InterpLibrary as JaxLibrary
from repro.kernels.flashattn.ops import attention_fused as jax_attention
from repro.kernels.flashattn.ops import \
    attention_fused_library as jax_attention_library
from repro.kernels.softmax.ops import \
    approx_softmax_library as jax_softmax_library
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.segment import explore_segmented as jax_explore_segmented
from repro_torch import api
from repro_torch.api import Explorer, ExploreConfig, InterpLibrary, spec_for
from repro_torch.kernels.flashattn.kernel import kv_splits, query_tile
from repro_torch.kernels.flashattn.ops import (attention_fused,
                                               attention_fused_library)
from repro_torch.kernels.flashattn.ref import (attention_fused_ref,
                                               flash_attention_ref)
from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library
from repro_torch.kernels.softmax.ops import approx_softmax_library
from repro_torch.numerics.ops import get_numerics, softmax_ulp_bound
from repro_torch.numerics.registry import get_table
from repro_torch.segment import explore_segmented


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fresh_default_sessions(tmp_path_factory):
    old, jold = api.default_explorer(), japi.default_explorer()
    api.set_default_explorer(Explorer(ExploreConfig(
        device="cpu", cache_dir=str(tmp_path_factory.mktemp("port")))))
    japi.set_default_explorer(japi.Explorer(japi.ExploreConfig(
        cache_dir=str(tmp_path_factory.mktemp("ref")))))
    yield
    api.set_default_explorer(old)
    japi.set_default_explorer(jold)


@pytest.fixture(scope="module")
def libs():
    """(port, reference) default libraries."""
    return (InterpLibrary.default_library("cpu"),
            japi.default_explorer().compile())


def _normal(seed, shape, scale=1.0, loc=0.0):
    return np.random.default_rng(seed).normal(loc, scale, shape).astype(
        np.float32)


# -- the library-bound composites and the fused backend ----------------------

def test_fused_numerics_requires_library():
    for get in (get_numerics, jax_get_numerics):
        with pytest.raises(ValueError, match="needs a compiled InterpLibrary"):
            get("interp", None, fused=True)
        with pytest.raises(ValueError, match="needs a compiled InterpLibrary"):
            get("interp-fused")


def test_library_softmax_unaligned_shapes(libs):
    """Any trailing width and leading shape: a distribution, within the
    softmax bound of the reference's."""
    lib, jlib = libs
    rng = np.random.default_rng(2)
    for shape in [(5,), (3, 33), (2, 4, 17)]:
        x = rng.normal(0, 3, shape).astype(np.float32)
        out = approx_softmax_library(torch.from_numpy(x), lib).numpy()
        assert out.shape == shape
        np.testing.assert_allclose(out.sum(-1), 1.0, atol=5e-3)
        np.testing.assert_allclose(
            out, np.asarray(jax_softmax_library(jnp.asarray(x), jlib)),
            rtol=softmax_ulp_bound(), atol=1e-30)


def test_fused_numerics_softmax_matches_library_kernel(libs):
    """The fused backend's softmax and rmsnorm are the library ops'
    (bitwise); a softmax over axis 0 takes the glue, still a
    distribution."""
    lib, _ = libs
    num = get_numerics("interp", lib, fused=True)
    x = torch.from_numpy(_normal(6, (8, 128), 3.0))
    assert torch.equal(num.softmax(x), approx_softmax_library(x, lib))
    y = num.softmax(x, axis=0).numpy()
    np.testing.assert_allclose(y.sum(0), 1.0, atol=5e-3)
    gamma = torch.ones(128)
    assert torch.equal(num.rmsnorm(x, gamma),
                       approx_rmsnorm_library(x, gamma, lib))


def test_fused_numerics_close_to_glue_numerics(libs):
    """The same tables through the fused lowering and the glue agree within
    a table ulp, as in the reference; each equals its reference twin."""
    lib, jlib = libs
    fused, glue = (get_numerics("interp", lib, fused=True),
                   get_numerics("interp", lib))
    xn = _normal(7, (8, 128), 3.0)
    x, gamma = torch.from_numpy(xn), torch.ones(128)
    np.testing.assert_allclose(fused.softmax(x).numpy(),
                               glue.softmax(x).numpy(), atol=2e-3)
    np.testing.assert_allclose(fused.rmsnorm(x, gamma).numpy(),
                               glue.rmsnorm(x, gamma).numpy(),
                               rtol=3e-3, atol=3e-3)
    for backend, fuse in ((fused, True), (glue, False)):
        jnum = jax_get_numerics("interp", jlib, fused=fuse)
        np.testing.assert_allclose(
            backend.softmax(x).numpy(),
            np.asarray(jnum.softmax(jnp.asarray(xn))),
            rtol=softmax_ulp_bound(), atol=1e-30)


def test_library_flash_grouped_kv_matches_expanded(libs):
    """Unexpanded (kvh < h) K/V == caller-expanded heads, bitwise, and
    the reference's within its flash bound."""
    lib, jlib = libs
    b, s, h, kvh, d = 2, 64, 4, 2, 64
    q, k, v = (_normal(9 + i, shape) for i, shape in
               enumerate([(b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)]))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    grouped = attention_fused_library(*t, lib, causal=True)
    expanded = attention_fused_library(
        t[0], t[1].repeat_interleave(h // kvh, 2),
        t[2].repeat_interleave(h // kvh, 2), lib, causal=True)
    assert torch.equal(grouped, expanded)
    want = np.asarray(jax_attention_library(
        *(jnp.asarray(a) for a in (q, k, v)), jlib, causal=True,
        use_kernel=False))
    np.testing.assert_allclose(grouped.numpy(), want, rtol=0,
                               atol=2 * softmax_ulp_bound() * np.abs(v).max())


# -- per-table flash attention ------------------------------------------------

def _qkv(seed, b, s, h, d, dtype=np.float32):
    """Normal q, k, v of (b, s, h, d) as torch and jax arrays of ``dtype``
    (bf16 values are the same in both)."""
    arrs = [jnp.asarray(_normal(seed + i, (b, s, h, d))).astype(dtype)
            for i in range(3)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in arrs]
    return ts, arrs


def _tile_twin(t, causal):
    """The CUDA kernel's CPU twin: its query tile, 64-key tiles and key
    splits."""
    b, s, h, d = t[0].shape
    tq = query_tile(s, 1, d)
    return attention_fused_ref(
        *t, get_table("exp2neg"), get_table("recip"), causal=causal,
        block_k=64, block_q=tq, kv_splits=kv_splits(b, h, -(-s // tq), s))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else a.astype(jnp.float32), np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_kernel_matches_ref(causal, dtype):
    """The kernel's tile twin against the plain oracle (the reference's
    tolerance), and the port's oracle against the reference's."""
    t, j = _qkv(0, 2, 256, 2, 128, dtype)
    got = _f32(_tile_twin(t, causal))
    ref = _f32(attention_fused(*t, causal=causal))
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-3)
    want = _f32(jax.jit(lambda *a: jax_attention(
        *a, causal=causal, use_kernel=False))(*j))
    np.testing.assert_allclose(ref, want, rtol=5e-2, atol=5e-3)


def _exact(q, k, v, causal):
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tri(q.shape[1], k.shape[1], dtype=bool), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def test_flash_kernel_close_to_exact_softmax():
    t, _ = _qkv(1, 1, 256, 2, 128)
    exact = _exact(*(a.numpy() for a in t), True)
    for got in (_tile_twin(t, True), attention_fused(*t, causal=True)):
        err = np.max(np.abs(got.numpy() - exact))
        assert err < 2.5e-2, err


def test_flash_kernel_shape_sweep():
    """Eight seeded (length, heads, causal) draws: the tile twin within the
    reference's tolerance of the oracle, the port's oracle of the
    reference's."""
    rng = np.random.default_rng(8)
    for i in range(8):
        s, h = int(rng.choice([128, 256, 384])), int(rng.choice([1, 2]))
        causal = bool(rng.integers(0, 2))
        t, j = _qkv(100 + i, 1, s, h, 128)
        got, ref = _tile_twin(t, causal), attention_fused(*t, causal=causal)
        assert got.shape == t[0].shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=5e-2,
                                   atol=5e-3)
        want = np.asarray(jax_attention(*j, causal=causal, use_kernel=False))
        np.testing.assert_allclose(ref.numpy(), want, rtol=5e-2, atol=5e-3)


def test_flash_dead_chunk_skip_equals_full():
    """Skipping the key tiles above each query tile's diagonal leaves the
    result within the oracle's tolerance (row 0 sees one key, the last row
    every key)."""
    t, _ = _qkv(2, 1, 512, 1, 128)
    got = _tile_twin(t, True).numpy()[0, :, 0]
    n = [a.transpose(1, 2).reshape(1, 512, 128) for a in t]
    ref = flash_attention_ref(*n, get_table("exp2neg"), get_table("recip"),
                              causal=True).numpy()[0]
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-3)


# -- the ROM walk's rows -------------------------------------------------------

def test_walk_rows_shapes(libs):
    """A library with a segmented slot: one walk row per kind, one datapath
    row per leaf (a uniform slot is one leaf), equal to the reference's; a
    v1 library sets no segment flag."""
    lib, jlib = libs
    spec, jspec = spec_for("tanh", 8), jax_spec_for("tanh", 8)
    sd = explore_segmented(spec, max_depth=6, engine="batched", device="cpu")
    jsd = jax_explore_segmented(jspec, max_depth=6, engine="batched")
    seg = InterpLibrary.from_designs([sd, get_table("sigmoid")],
                                     ["tanh", "sigmoid"], device="cpu")
    jseg = JaxLibrary.from_designs([jsd, japi.default_explorer().get_table(
        "sigmoid")], ["tanh", "sigmoid"])
    for port, ref in ((seg, jseg), (lib, jlib)):
        walk, dp = port.walk_rows()
        jwalk, jdp = ref.walk_rows()
        np.testing.assert_array_equal(walk.numpy(), np.asarray(jwalk))
        np.testing.assert_array_equal(dp.numpy(), np.asarray(jdp))
        assert tuple(walk.shape) == (len(port.kinds), 5)
        n_leaves = sum(len(m.seg_meta) if m.seg_depth else 1
                       for m in port.metas)
        assert tuple(dp.shape) == (n_leaves, 5)
    assert seg.segmented_kinds == ("tanh",)
    assert int(lib.walk_rows()[0][:, 2].sum()) == 0
