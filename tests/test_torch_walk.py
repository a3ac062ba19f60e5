"""ROM v2 in the port: segmented library slots, the mixed uniform/segmented
ROM walk and the segment-index datapath of every fused consumer, held
against the reference on the same libraries and inputs.

Fixtures: the default manifest segmented by each package (every slot of it
segmented, ``f775a828748d4ea9``), a mixed library (tanh and sigmoid
segmented, the other six uniform) and the uniform default library.

Tolerances:
* integer table outputs (``interp_eval_seg_ref``, ``library_walk_ref``,
  ``rom_eval_ref``, ``eval_int``, the reference's interpret-mode
  ``library_walk_2d`` / ``rom_eval_2d``): bit-exact, every code;
* libraries, manifests and ROM bytes: equal;
* softmax on a segmented library: relative ``softmax_ulp_bound`` of its
  exp2neg / recip slots (the bound reads only their widths, which a
  segmented slot shares with the uniform one), exp codes bit-exact;
* rmsnorm: rtol 1e-6 where mean(x^2) agrees bitwise, else two rsqrt-table
  ulps (2 * 2^-(out_bits-1)), as ``test_torch_rmsnorm.py``;
* attention: |diff| <= softmax_ulp_bound * max|v| against the reference's
  unchunked oracle, (n_chunks + 2) times that for the tile-by-tile twin;
* activations through the float glue: one table ulp of the output span;
* smoke ``deepseek_moe_16b`` logits: 4 * 2^-12 * max|logit|, greedy tokens
  tie-aware, as ``test_torch_model.py``.
"""
from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.api.library import InterpLibrary as JaxLibrary
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.kernels.flashattn.ops import \
    attention_fused_library as jax_attention
from repro.kernels.interp.kernel import library_walk_2d, rom_eval_2d
from repro.kernels.interp.ref import interp_eval_seg_ref as jax_seg_ref
from repro.kernels.interp.ref import library_walk_ref as jax_walk_ref
from repro.kernels.rmsnorm.ref import fused_rmsnorm_lib_ref as jax_rms_ref
from repro.kernels.softmax.ops import lib_meta as jax_lib_meta
from repro.kernels.softmax.ref import fused_softmax_lib_ref as jax_sm_ref
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.numerics.ops import softmax_ulp_bound as jax_softmax_ulp_bound
from repro_torch.api import spec_for
from repro_torch.api.library import DEFAULT_LIBRARY_KINDS, InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flashattn.ref import attention_fused_library_ref
from repro_torch.kernels.interp.ops import (lib_meta, library_walk,
                                            rom_eval)
from repro_torch.kernels.interp.ref import (interp_eval_seg_ref,
                                            library_eval_ref,
                                            library_walk_ref, rom_eval_ref)
from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_lib_ref
from repro_torch.kernels.softmax.ref import (fused_softmax_lib_ref,
                                             softmax_exp)
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import (FusedInterpNumerics, InterpNumerics,
                                      PlainFusedNumerics, get_numerics,
                                      softmax_ulp_bound)
from repro_torch.segment import explore_segmented

SEG_ROM_SHA = "f775a828748d4ea9"
MIXED_SEG = ("tanh", "sigmoid")
EPS = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seg():
    """(port library, reference library, port designs by kind): the default
    manifest with every slot segmented at its uniform R, as
    ``compile_segmented`` builds it."""
    designs = {}
    for kind in DEFAULT_LIBRARY_KINDS:
        spec = spec_for(kind)
        designs[kind] = explore_segmented(spec, max_depth=6,
                                          engine="batched", device="cpu")
    lib = InterpLibrary.from_designs([designs[k] for k in
                                      DEFAULT_LIBRARY_KINDS],
                                     DEFAULT_LIBRARY_KINDS, device="cpu")
    return lib, default_explorer().compile_segmented(), designs


@pytest.fixture(scope="module")
def mixed(seg):
    """Segmented tanh and sigmoid next to six uniform slots (r_max 64)."""
    lib, _, designs = seg
    uni = InterpLibrary.default_library("cpu")
    port = InterpLibrary.from_designs(
        [designs[k] if k in MIXED_SEG else _uniform_design(k)
         for k in DEFAULT_LIBRARY_KINDS], DEFAULT_LIBRARY_KINDS,
        device="cpu")
    assert port.r_max == uni.r_max == 64
    ref = default_explorer().compile_segmented(segment=MIXED_SEG)
    return port, ref


def _uniform_design(kind):
    from repro_torch.api.library import DEFAULT_TABLE_KEY, TABLES_DIR
    from repro_torch.core.table import TableDesign

    return TableDesign.from_dict(json.loads(
        (TABLES_DIR / f"{kind}_{DEFAULT_TABLE_KEY}.json").read_text()))


@pytest.fixture(scope="module")
def uniform():
    return InterpLibrary.default_library("cpu"), default_explorer().compile()


def _libs(request, name):
    if name == "uniform":
        return request.getfixturevalue("uniform")
    if name == "mixed":
        return request.getfixturevalue("mixed")
    return request.getfixturevalue("seg")[:2]


# -- the library artifact ---------------------------------------------------

@pytest.mark.parametrize("name", ["seg", "mixed"])
def test_v2_library_equals_reference(name, request):
    lib, jlib = _libs(request, name)
    if name == "seg":
        assert lib.rom_sha() == SEG_ROM_SHA
    assert lib.rom_sha() == jlib.rom_sha()
    np.testing.assert_array_equal(lib.coeffs.numpy(), np.asarray(jlib.coeffs))
    assert tuple(_meta_dicts(lib)) == tuple(_meta_dicts(jlib))
    assert lib.manifest() == jlib.manifest()
    assert lib.segmented_kinds == jlib.segmented_kinds
    for got, want in zip(lib.walk_rows(), jlib.walk_rows()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for m, jm in zip(lib.metas, jlib.metas):
        assert (m.segmented, m.rows_used, m.seg_spec()) == \
            (jm.segmented, jm.rows_used, jm.seg_spec())


@pytest.mark.parametrize("name", ["seg", "mixed", "uniform"])
def test_slot_args_address_the_reference_leaf_rows(name, request):
    """The fused kernels' 12-int slot row points ``leaf_base`` / ``n_leaves``
    at exactly the leaf datapath rows the reference's ``lib_meta`` carries
    in ``eval["seg"]`` (a uniform slot: its one datapath row)."""
    from repro_torch.kernels.interp.kernel import slot_args

    lib, jlib = _libs(request, name)
    dp = lib.walk_rows()[1].numpy()
    for kind in lib.kinds:
        row = slot_args(lib, kind)
        seg_depth, n_leaves, leaf_base = row[9:]
        ev = jax_lib_meta(jlib, kind)["eval"]
        if "seg" in ev:
            _, depth, n, leaf_meta = ev["seg"]
            want = np.asarray(leaf_meta)
            assert (seg_depth, n_leaves) == (depth, n)
        else:
            want = np.asarray([[ev[f] for f in ("eval_bits", "k", "sq_trunc",
                                                "lin_trunc", "degree")]])
            assert (seg_depth, n_leaves) == (0, 1)
        np.testing.assert_array_equal(dp[leaf_base:leaf_base + n_leaves],
                                      want)


def _meta_dicts(lib):
    return [json.dumps(m.to_dict(), sort_keys=True) for m in lib.metas]


@pytest.mark.parametrize("name", ["seg", "mixed"])
def test_v2_library_loads_across_packages(name, request, tmp_path):
    """A v2 library saved by either package loads in the other with equal
    metas, ROM and manifest."""
    lib, jlib = _libs(request, name)
    port_man = lib.save(tmp_path / "port" / "lib")
    ref_man = jlib.save(tmp_path / "ref" / "lib")
    assert json.loads(port_man.read_text()) == json.loads(ref_man.read_text())
    assert json.loads(port_man.read_text())["version"] == 2
    in_ref = JaxLibrary.load(port_man)
    in_port = InterpLibrary.load(ref_man, device="cpu")
    assert in_ref.metas == jlib.metas
    assert in_port.metas == lib.metas
    assert in_port.rom_sha() == in_ref.rom_sha() == lib.rom_sha()
    assert in_port.sealed_sha == lib.rom_sha()
    np.testing.assert_array_equal(in_port.coeffs.numpy(),
                                  np.asarray(in_ref.coeffs))
    assert hash(in_port.metas)  # seg_meta re-frozen to tuples


def test_v1_manifest_byte_identical(uniform, tmp_path):
    """A library with no segmented slot still saves as version 1, byte for
    byte the reference's manifest, and carries no seg fields."""
    lib, jlib = uniform
    port = lib.save(tmp_path / "port" / "lib").read_bytes()
    ref = jlib.save(tmp_path / "ref" / "lib").read_bytes()
    assert port == ref
    doc = json.loads(port)
    assert doc["version"] == 1
    assert all("seg_depth" not in f and "seg_meta" not in f
               for f in doc["funcs"])


# -- integer datapath ---------------------------------------------------------

@pytest.mark.parametrize("kind", DEFAULT_LIBRARY_KINDS)
def test_segmented_slot_every_code(kind, seg):
    """Every code of every segmented slot: interp_eval_seg_ref, eval_int,
    the walk (eval_fused), rom_eval's plain version and the reference's
    interp_eval_seg_ref all equal the design's int64 eval_int."""
    lib, jlib, designs = seg
    m = lib.meta(kind)
    codes = np.arange(1 << m.in_bits, dtype=np.int32)
    ct = torch.from_numpy(codes)
    want = designs[kind].eval_int(codes)
    fid = lib.func_id(kind)
    got = {
        "interp_eval_seg_ref": interp_eval_seg_ref(ct, lib.coeffs[fid],
                                                   seg=m.seg_spec()),
        "eval_int": lib.eval_int(ct, kind),
        "eval_fused": lib.eval_fused(ct, fid),
        "rom_eval": rom_eval(ct, lib, kind),
        "reference": torch.from_numpy(np.array(jax_seg_ref(
            jnp.asarray(codes), jlib.coeffs[fid],
            seg=jlib.meta(kind).seg_spec()))),
    }
    for name, g in got.items():
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy().astype(np.int64), want,
                                      err_msg=name)


@pytest.mark.parametrize("name", ["seg", "mixed", "uniform"])
def test_library_walk_ref_matches_reference_kernel(name, request):
    """Two (8, 128) tiles of random in-range codes and per-element function
    ids: the port's plain walk == the reference's gather oracle == the
    reference's ``library_walk_2d`` in interpret mode, bitwise."""
    lib, jlib = _libs(request, name)
    walk, dp = lib.walk_rows()
    rng = np.random.default_rng(len(name))
    fids = rng.integers(0, len(lib), (16, 128)).astype(np.int32)
    in_bits = np.array([m.in_bits for m in lib.metas])[fids]
    codes = (rng.integers(0, 1 << 30, fids.shape) % (1 << in_bits)
             ).astype(np.int32)
    got = library_walk(torch.from_numpy(codes), torch.from_numpy(fids),
                       lib.coeffs, walk, dp).numpy()
    jw, jdp = jlib.walk_rows()
    want = np.asarray(jax_walk_ref(jnp.asarray(codes), jnp.asarray(fids),
                                   jlib.coeffs, jw, jdp))
    kern = np.asarray(library_walk_2d(jnp.asarray(codes), jnp.asarray(fids),
                                      jlib.coeffs, jw, jdp, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kern)
    # one id for every element takes the same plain version
    one = library_walk(torch.from_numpy(codes[0]), 3, lib.coeffs, walk, dp)
    np.testing.assert_array_equal(
        one.numpy(), library_walk_ref(torch.from_numpy(codes[0]),
                                      torch.full((128,), 3, dtype=torch.int32),
                                      lib.coeffs, walk, dp).numpy())


def test_walk_on_uniform_library_equals_library_eval(uniform):
    """On an all-uniform library the walk is library_eval, every code of
    every kind (the uniform elements' clamped segment-table read is
    discarded)."""
    lib, _ = uniform
    walk, dp = lib.walk_rows()
    assert not lib.segmented_kinds
    np.testing.assert_array_equal(dp.numpy(), lib.meta_rows().numpy())
    codes = torch.arange(4096, dtype=torch.int32).repeat(len(lib))
    fids = torch.arange(len(lib), dtype=torch.int32).repeat_interleave(4096)
    np.testing.assert_array_equal(
        library_walk_ref(codes, fids, lib.coeffs, walk, dp).numpy(),
        library_eval_ref(codes, fids, lib.coeffs, lib.meta_rows()).numpy())


@pytest.mark.parametrize("kind", DEFAULT_LIBRARY_KINDS)
def test_rom_eval_ref_matches_reference_interpret_kernel(kind, seg):
    """``rom_eval_ref`` on every code of each segmented slot equals the
    reference's ``rom_eval_2d`` (``_lut_rom`` -> ``_lut_seg``) in
    interpret mode."""
    lib, jlib, _ = seg
    m, jm = lib.meta(kind), jlib.meta(kind)
    codes = np.arange(1 << m.in_bits, dtype=np.int32).reshape(-1, 128)
    dp = dict(fid=lib.func_id(kind), r_max=lib.r_max, eval_bits=m.eval_bits,
              k=m.k, sq_trunc=m.sq_trunc, lin_trunc=m.lin_trunc,
              degree=m.degree)
    got = rom_eval_ref(torch.from_numpy(codes), lib.coeffs.reshape(-1, 3),
                       seg=m.seg_spec(), **dp)
    want = rom_eval_2d(jnp.asarray(codes), jlib.coeffs.reshape(-1, 3),
                       seg=jm.seg_spec(), interpret=True, **dp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rom_eval_ref_uniform_slot_matches_reference_kernel(mixed):
    lib, jlib = mixed
    m = lib.meta("recip")
    assert not m.segmented
    codes = np.arange(4096, dtype=np.int32).reshape(-1, 128)
    dp = dict(fid=lib.func_id("recip"), r_max=lib.r_max,
              eval_bits=m.eval_bits, k=m.k, sq_trunc=m.sq_trunc,
              lin_trunc=m.lin_trunc, degree=m.degree)
    got = rom_eval_ref(torch.from_numpy(codes), lib.coeffs.reshape(-1, 3),
                       **dp)
    want = rom_eval_2d(jnp.asarray(codes), jlib.coeffs.reshape(-1, 3),
                       interpret=True, **dp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        rom_eval(torch.from_numpy(codes), lib, "recip").numpy(),
        got.numpy())


@pytest.mark.parametrize("case,exc", [("codes_int64", TypeError),
                                      ("two_devices", ValueError),
                                      ("empty", None)])
def test_rom_eval_wrapper_checks_before_any_build(case, exc, seg,
                                                  monkeypatch):
    """``rom_eval_cuda`` refuses int64 codes and a library on another
    device than the codes before it builds or loads the kernels, and an
    empty call returns without a launch (a malformed segmented slot is the
    C entry's to refuse, on the card)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.interp.kernel import rom_eval_cuda

    lib = seg[0]
    monkeypatch.setattr(build, "load", lambda: pytest.fail("built"))
    n0 = build.LAUNCHES["rom_eval"]
    codes = {"codes_int64": torch.zeros(8, dtype=torch.int64),
             "two_devices": torch.zeros(8, dtype=torch.int32,
                                        device="meta"),
             "empty": torch.zeros(2, 0, dtype=torch.int32)}[case]
    if exc is None:
        out = rom_eval_cuda(codes, lib, "tanh")
        assert out.shape == codes.shape and out.dtype == torch.int32
    else:
        with pytest.raises(exc):
            rom_eval_cuda(codes, lib, "tanh")
    assert build.LAUNCHES["rom_eval"] == n0


def test_lib_meta_carries_the_segment_spec(mixed):
    lib, jlib = mixed
    for kind in DEFAULT_LIBRARY_KINDS:
        got, want = lib_meta(lib, kind), jax_lib_meta(jlib, kind)
        assert got == want
        assert ("seg" in got["eval"]) == (kind in MIXED_SEG)


# -- fused consumers' plain versions ------------------------------------------

def _softmax_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 8.0, shape[:-1] + (1,))
         ).astype(np.float32)
    x.reshape(-1, shape[-1])[1, ::3] = -200.0  # past the t = 126 clamp
    return x


@pytest.mark.parametrize("shape", [(16, 64), (8, 256)])
def test_softmax_plain_on_segmented_library(shape, seg):
    lib, jlib, _ = seg
    x = _softmax_inputs(shape, seed=shape[1])
    em, rm = lib_meta(lib, "exp2neg"), lib_meta(lib, "recip")
    got = fused_softmax_lib_ref(torch.from_numpy(x), lib.coeffs, em, rm)
    want = np.asarray(jax_sm_ref(jnp.asarray(x), jlib.coeffs,
                                 jax_lib_meta(jlib, "exp2neg"),
                                 jax_lib_meta(jlib, "recip")))
    bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    assert bound == jax_softmax_ulp_bound(jlib.meta("exp2neg"),
                                          jlib.meta("recip"))
    g = got.numpy()
    assert np.all(np.abs(g - want) <= bound * np.abs(want) + 1e-30)
    # the exp codes are the reference's and the terms read the seg slot
    codes, e = softmax_exp(torch.from_numpy(x), lib.coeffs, em)
    tab = interp_eval_seg_ref(codes, lib.coeffs[em["fid"]],
                              seg=em["eval"]["seg"])
    m = torch.from_numpy(x).amax(-1, keepdim=True)
    n = torch.floor(torch.clamp((m - torch.from_numpy(x)) * 1.4426950408889634,
                                max=126.0))
    np.testing.assert_array_equal(
        e.numpy(), (tab.float() * 2.0 ** -em["out_bits"]
                    * torch.pow(2.0, -n)).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_on_segmented_library(dtype, seg):
    lib, jlib, _ = seg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 256)).astype(np.float32) * \
        rng.uniform(0.05, 20.0, (8, 1)).astype(np.float32)
    x[:3] = rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], (3, 256))
    gamma = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    got = fused_rmsnorm_lib_ref(xt, torch.from_numpy(gamma), lib.coeffs,
                                lib_meta(lib, "rsqrt"), EPS).float().numpy()
    want = np.asarray(jax_rms_ref(xj, jnp.asarray(gamma), jlib.coeffs,
                                  jax_lib_meta(jlib, "rsqrt"),
                                  EPS).astype(jnp.float32))
    xf = np.asarray(xt.float())
    same = ((torch.from_numpy(xf) ** 2).mean(-1) + EPS).numpy() == \
        np.asarray(jnp.mean(jnp.asarray(xf) ** 2, -1) + EPS)
    assert same[:3].all()
    bf16 = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    table_tol = 2 * 2.0 ** -(lib.meta("rsqrt").out_bits - 1)
    np.testing.assert_allclose(got[same], want[same], rtol=1e-6 + bf16)
    np.testing.assert_allclose(got, want, rtol=table_tol + bf16, atol=1e-30)


@pytest.mark.parametrize("case", ["gqa_prefill", "decode_dead_slots"])
def test_attention_plain_on_segmented_library(case, seg):
    lib, jlib, _ = seg
    rng = np.random.default_rng(7)
    b, h, kvh, d = 2, 4, 2, 16
    sq, sk = (24, 24) if case == "gqa_prefill" else (1, 40)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    kv_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    if case == "gqa_prefill":
        q_pos = kv_pos.copy()
    else:
        q_pos = np.array([[20], [35]], np.int32)
        kv_pos[0, 21:] = -1
        kv_pos[1, ::3] = -1
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)]
    got = attention_fused_library_ref(*t[:3], lib, q_pos=t[3],
                                      kv_pos=t[4]).numpy()
    ref = jax.jit(functools.partial(jax_attention, use_kernel=False))
    want = np.asarray(ref(*(jnp.asarray(a) for a in (q, k, v)), jlib,
                          q_pos=jnp.asarray(q_pos),
                          kv_pos=jnp.asarray(kv_pos)))
    bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    vmax = np.abs(v).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=bound * vmax)
    chunked = attention_fused_library_ref(*t[:3], lib, q_pos=t[3],
                                          kv_pos=t[4], block_k=8).numpy()
    n_chunks = (sk + 7) // 8
    np.testing.assert_allclose(chunked, got, rtol=0,
                               atol=(n_chunks + 2) * bound * vmax)


@pytest.mark.parametrize("window", [None, 5])
def test_chunked_twin_skips_dead_tiles_as_the_reference_kernel(window, seg):
    """On the segmented library tab(0) of exp2neg is 8191, not 2^13, so a
    key tile that leaves the running max unchanged scales l and the
    accumulator by 1 - 2^-13: skipping a dead tile is no longer a no-op.
    The tile-by-tile twin with the reference's per-query-tile skip
    (``block_q``) against the reference kernel in interpret mode with the
    same tiles: only float reassociation separates them (max within one
    table-ulp flip, bound * max|v|; mean at float level)."""
    from repro.kernels.flashattn.kernel import flash_attention_lib
    from repro_torch.kernels.flashattn.ref import \
        flash_attention_lib_chunked_ref

    lib, jlib, designs = seg
    assert designs["exp2neg"].eval_int(np.zeros(1, np.int64))[0] == 8191
    rng = np.random.default_rng(21)
    g, sq, sk, d = 2, 16, 32, 8
    q = rng.standard_normal((2 * g, sq, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, d)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(8, 24, dtype=np.int32), (2 * g, sq))
    kv_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (2, sk)).copy()
    kv_pos[1, 20:] = -1
    kern = np.asarray(flash_attention_lib(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)),
        jlib.coeffs.reshape(-1, 3), jax_lib_meta(jlib, "exp2neg"),
        jax_lib_meta(jlib, "recip"), r_max=jlib.coeffs.shape[1],
        window=window, kv_group=g, block_q=8, block_k=8, interpret=True))
    t = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in
         dict(q=q, k=k, v=v, qp=q_pos, kp=kv_pos).items()}
    args = (t["q"], t["k"].repeat_interleave(g, 0),
            t["v"].repeat_interleave(g, 0), t["qp"],
            t["kp"].repeat_interleave(g, 0), lib.coeffs,
            lib_meta(lib, "exp2neg"), lib_meta(lib, "recip"))
    got = flash_attention_lib_chunked_ref(*args, window=window, block_k=8,
                                          block_q=8).numpy()
    bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    err = np.abs(got - kern)
    assert err.max() <= bound * np.abs(v).max()
    assert err.mean() <= 1e-5
    every = flash_attention_lib_chunked_ref(*args, window=window, block_k=8
                                            ).numpy()
    assert np.abs(every - kern).mean() > err.mean()  # the skip is seen


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("window", [None, 10])
def test_split_twin_on_segmented_library(window, splits, seg):
    """The tile twin with key splits on the segmented library, where tab(0)
    = 8191 makes every split's combine factor c_s a real rescale: decode
    rows whose cache lengths (and, with a window, its reach) leave whole
    splits dead, against the reference's unfused oracle within the chunked
    tolerance (n_tiles + 2) * bound * max|v|."""
    from repro_torch.kernels.flashattn.kernel import query_tile

    lib, jlib, _ = seg
    rng = np.random.default_rng(17)
    b, h, kvh, d, sk = 3, 4, 2, 16, 64
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    q_pos = np.array([[5], [40], [63]], np.int32)
    kv_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    kv_pos[0, 6:] = -1
    kv_pos[1, 41:] = -1
    kv_pos[2, 10:30] = -1
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)]
    got = attention_fused_library_ref(
        *t[:3], lib, q_pos=t[3], kv_pos=t[4], window=window, block_k=8,
        block_q=query_tile(1, h // kvh, d), kv_splits=splits).numpy()
    ref = jax.jit(functools.partial(jax_attention, use_kernel=False,
                                    window=window))
    want = np.asarray(ref(*(jnp.asarray(a) for a in (q, k, v)), jlib,
                          q_pos=jnp.asarray(q_pos),
                          kv_pos=jnp.asarray(kv_pos)))
    bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    assert np.abs(got - want).max() <= (sk // 8 + 2) * bound * np.abs(v).max()


# -- numerics backends --------------------------------------------------------

def test_plain_fused_numerics_walks_a_segmented_library(seg, mixed):
    """PlainFusedNumerics evaluates through the walk once a slot is
    segmented: every code equals eval_int. ``library_eval_ref`` on the meta
    rows would read leaf 0's datapath for every element, and is wrong."""
    for lib in (seg[0], mixed[0]):
        plain = PlainFusedNumerics(lib)
        codes = torch.arange(4096, dtype=torch.int32)
        wrong = 0
        for kind in lib.segmented_kinds:
            want = lib.eval_int(codes, kind)
            assert torch.equal(plain._eval(kind)(codes), want)
            fids = torch.full_like(codes, lib.func_id(kind))
            wrong += not torch.equal(
                library_eval_ref(codes, fids, lib.coeffs, lib.meta_rows()),
                want)
        assert wrong


@pytest.mark.parametrize("op", ["silu", "exp_neg", "recip_pos", "rsqrt_pos"])
def test_interp_numerics_on_segmented_library(op, seg):
    """The glue ops on a segmented library: the interp, fused and plain
    fused backends agree bitwise inside the port, and with the reference's
    interp backend within one table ulp."""
    lib, jlib, _ = seg
    rng = np.random.default_rng(11)
    if op == "silu":
        x = rng.uniform(-10.0, 10.0, 512).astype(np.float32)
    elif op == "exp_neg":
        x = -rng.exponential(4.0, 512).astype(np.float32)
    else:
        x = rng.lognormal(0.0, 3.0, 512).astype(np.float32)
    xt = torch.from_numpy(x)
    outs = [getattr(cls(lib), op)(xt) for cls in
            (InterpNumerics, FusedInterpNumerics, PlainFusedNumerics)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = np.asarray(getattr(jax_get_numerics("interp", jlib), op)(
        jnp.asarray(x)))
    kind = {"silu": "silu", "exp_neg": "exp2neg", "recip_pos": "recip",
            "rsqrt_pos": "rsqrt"}[op]
    m = lib.meta(kind)
    ulp = (m.act_span if m.act_span else 2.0) * 2.0 ** -m.out_bits
    tol = ulp * np.maximum(1.0, np.abs(want) if op != "silu" else 1.0)
    assert np.all(np.abs(outs[0].numpy() - want) <= tol)


def test_smoke_moe_logits_on_segmented_library(seg):
    """deepseek_moe_16b smoke (float32, the reference's parameters) under
    interp-fused numerics on the segmented library: prefill and three
    decode steps against the reference's, greedy tokens tie-aware."""
    lib, jlib, _ = seg
    jcfg = jax_smoke_config("deepseek_moe_16b")
    cfg = get_smoke_config("deepseek_moe_16b")
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jnum = jax_get_numerics("interp-fused", jlib)
    tnum = get_numerics("interp-fused", lib)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13)
                                             ).astype(np.int32)
    jlog, jcache, _ = jax.jit(functools.partial(
        jtf.prefill, cfg=jcfg, numerics=jnum, cache_len=32))(
            jparams, jnp.asarray(toks))
    tlog, tcache = tf.prefill(params, torch.from_numpy(toks).long(), cfg,
                              tnum, 32)
    jlog = np.asarray(jlog)
    tol = 4 * 2.0 ** -12 * np.abs(jlog).max()
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0, atol=tol)
    _assert_greedy(jlog, tlog.numpy(), tol)
    jdec = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg,
                                     numerics=jnum))
    pos = np.array([13, 13], np.int32)
    tok = jlog[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):  # teacher-forced with the reference's tokens
        jlog2, jcache = jdec(jparams, jnp.asarray(tok), jnp.asarray(pos),
                             jcache)
        tlog2, tcache = tf.decode_step(params, torch.from_numpy(tok).long(),
                                       torch.from_numpy(pos), tcache, cfg,
                                       tnum)
        jlog2 = np.asarray(jlog2)
        tol = 4 * 2.0 ** -12 * np.abs(jlog2).max()
        np.testing.assert_allclose(tlog2.numpy(), jlog2, rtol=0, atol=tol)
        _assert_greedy(jlog2, tlog2.numpy(), tol)
        tok = jlog2[:, -1].argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1


def _assert_greedy(ref_logits, got_logits, tol):
    ref = ref_logits.reshape(-1, ref_logits.shape[-1])
    got = got_logits.reshape(-1, got_logits.shape[-1])
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(ref.argmax(-1)[clear], got.argmax(-1)[clear])


# -- the serving CLI ----------------------------------------------------------

def test_serve_cli_library_flags(seg, tmp_path, capsys):
    """``--library`` serves a saved v2 artifact (here one the reference
    saved), ``--save-library`` writes what the engine serves; the smoke
    config on the CPU through the plain versions, no kernel launches."""
    from repro_torch.launch.serve import main

    _, jlib, _ = seg
    man = jlib.save(tmp_path / "ref_seg")
    out = tmp_path / "served"
    main(["--arch", "deepseek_moe_16b", "--smoke", "--device", "cpu",
          "--requests", "2", "--max-new", "3", "--library", str(man),
          "--save-library", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert report["rom_sha"] == SEG_ROM_SHA and report["tokens"] == 6
    assert set(report["stats"]["launches"].values()) == {0}
    assert any(line.startswith("saved library -> ") for line in lines)
    again = InterpLibrary.load(out, device="cpu")
    assert again.rom_sha() == SEG_ROM_SHA
    assert again.manifest() == jlib.manifest()
    with pytest.raises(SystemExit):
        main(["--arch", "yi_6b", "--smoke", "--device", "cpu",
              "--numerics", "exact", "--library", str(man)])
