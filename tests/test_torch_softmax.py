"""The library-bound fused softmax: the port's plain version against the
reference's ``fused_softmax_lib`` in interpret mode and its jnp oracle
``fused_softmax_lib_ref``, and every numerics backend's ``softmax`` against
the reference's.

Tolerances:
* exp2neg table codes: bit-exact (they come from the row max and one
  element, computed in the same float32 order in both packages).
* outputs: relative ``softmax_ulp_bound`` of the two tables. Where the
  codes agree the terms e differ only by the reference's float32 ``exp2``
  of an integer (a few f32 ulps on the CPU, and 2^-126 flushed to 0; the
  port takes exact powers of two), and the row sum's order may move the
  reciprocal's code by one step, both far inside the bound; bf16 outputs
  add one output rounding (2^-7 relative). An absolute 1e-30 covers the
  flushed 2^-126 terms.
* the exact backend: torch.softmax against jax.nn.softmax, rtol 1e-6.
* the CUDA kernels' order of the row sum (``kernel_row_sum``) against the
  reference's: the reciprocal's code moves by at most one (the card tests'
  one-step tolerance rests on it) while D * 2^-24 stays near 2^-12 or
  below; the exp codes equal the reference's bitwise.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.kernels.flashattn.kernel import _table_exp_neg
from repro.kernels.interp.kernel import _lut_rom
from repro.kernels.softmax.kernel import fused_softmax_lib
from repro.kernels.softmax.ops import lib_meta as jax_lib_meta
from repro.kernels.softmax.ref import fused_softmax_lib_ref as jax_ref
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro_torch.api import spec_for
from repro_torch.api.library import (DEFAULT_LIBRARY_KINDS, DEFAULT_TABLE_KEY,
                                     TABLES_DIR, InterpLibrary)
from repro_torch.core.table import TableDesign
from repro_torch.kernels import build
from repro_torch.kernels.softmax.kernel import (launch_shape,
                                                softmax_lib_cuda,
                                                softmax_tab_cuda, vector_ok)
from repro_torch.kernels.softmax.ops import approx_softmax_library, lib_meta
from repro_torch.kernels.softmax.ref import (fused_softmax_lib_ref,
                                             kernel_order_softmax,
                                             kernel_row_sum, softmax_exp)
from repro_torch.numerics.ops import (PlainFusedNumerics, get_numerics,
                                      softmax_ulp_bound)
from repro_torch.segment import explore_segmented

LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    return InterpLibrary.default_library("cpu"), default_explorer().compile()


def _inputs(shape, seed=0):
    """Router-like logits; row 0 is constant (every term ties) and row 1
    spreads past the t = 126 clamp of the exp table."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 8.0, shape[:-1] + (1,))
         ).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.75
    flat[1, ::3] = -200.0
    return x


def _jax_exp_codes(x, eb):
    """The exp2neg codes of the reference's ``_softmax_body`` (its first
    lines, in jnp on the same float32 inputs)."""
    xf = jnp.asarray(x, jnp.float32)
    m = jnp.max(xf, axis=-1, keepdims=True)
    t = jnp.minimum((m - xf) * LOG2E, 126.0)
    frac = t - jnp.floor(t)
    return np.asarray(jnp.clip(jnp.round(frac * (1 << eb)).astype(jnp.int32),
                               0, (1 << eb) - 1))


def _tol(lib, dtype):
    bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    return bound + (2.0 ** -7 if dtype == "bfloat16" else 0.0)


def _assert_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= rel * np.abs(want) + 1e-30), \
        float(np.max(np.abs(got - want) / (np.abs(want) + 1e-30)))


def _both(x, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return xt, xj


@pytest.mark.parametrize("shape", [(16, 128), (8, 256)])
def test_plain_twin_matches_reference_kernel_interpret(shape, libs):
    lib, jlib = libs
    x = _inputs(shape, seed=shape[1])
    em, rm = jax_lib_meta(jlib, "exp2neg"), jax_lib_meta(jlib, "recip")
    want = fused_softmax_lib(jnp.asarray(x), jlib.coeffs.reshape(-1, 3), em,
                             rm, r_max=jlib.coeffs.shape[1], interpret=True)
    got = approx_softmax_library(torch.from_numpy(x), lib)
    _assert_close(got.numpy(), want, _tol(lib, "float32"))
    codes, _ = softmax_exp(torch.from_numpy(x), lib.coeffs,
                           lib_meta(lib, "exp2neg"))
    np.testing.assert_array_equal(codes.numpy(),
                                  _jax_exp_codes(x, em["in_bits"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 64), (4, 1, 64)])
def test_plain_twin_matches_reference_oracle(shape, dtype, libs):
    lib, jlib = libs
    xt, xj = _both(_inputs(shape, seed=len(shape)), dtype)
    em, rm = jax_lib_meta(jlib, "exp2neg"), jax_lib_meta(jlib, "recip")
    want = jax_ref(xj.reshape(-1, shape[-1]), jlib.coeffs, em, rm
                   ).reshape(shape)
    got = fused_softmax_lib_ref(xt, lib.coeffs, lib_meta(lib, "exp2neg"),
                                lib_meta(lib, "recip"))
    assert got.dtype == xt.dtype and tuple(got.shape) == shape
    _assert_close(got.float().numpy(), want.astype(jnp.float32),
                  _tol(lib, dtype))
    codes, e = softmax_exp(xt, lib.coeffs, lib_meta(lib, "exp2neg"))
    np.testing.assert_array_equal(codes.numpy(), _jax_exp_codes(
        np.asarray(xj.astype(jnp.float32)), em["in_bits"]))
    # a constant row: every term is tab(0) * 2^-out_bits, all equal
    e0 = e.reshape(-1, shape[-1])[0]
    assert torch.equal(e0, torch.full_like(e0, float(e0[0])))
    # the clamp: t = 126 gives the smallest normal power of two scale
    assert float(e.reshape(-1, shape[-1])[1, 0]) <= 2.0 ** -125


def test_segmented_slot_raises(libs):
    """A segmented slot decodes through the segment-index datapath; a
    segment spec that does not fit its slot (more leaf and table rows than
    the ROM's r_max, or a leaf count its rows do not match) raises."""
    lib, _ = libs
    em = lib_meta(lib, "exp2neg")
    em["eval"]["seg"] = (12, 8, 3, ((4, 0, 0, 0, 1),) * 3)
    with pytest.raises(ValueError, match="does not fit"):
        fused_softmax_lib_ref(torch.zeros(2, 8), lib.coeffs, em,
                              lib_meta(lib, "recip"))
    em["eval"]["seg"] = (12, 2, 3, ((10, 0, 0, 0, 1),) * 2)
    with pytest.raises(ValueError, match="does not fit"):
        fused_softmax_lib_ref(torch.zeros(2, 8), lib.coeffs, em,
                              lib_meta(lib, "recip"))


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("name", ["exact", "interp", "interp-fused",
                                  "plain-fused"])
def test_backend_softmax_matches_reference(name, axis, libs):
    """Each backend against the reference's on the same (6, 9, 64) logits;
    ``axis=0`` sends the fused backends to the glue path, as the
    reference's does."""
    lib, jlib = libs
    x = _inputs((6, 9, 64), seed=5)
    if name == "plain-fused":
        num, jname = PlainFusedNumerics(lib), "interp-fused"
    else:
        num = get_numerics(name, None if name == "exact" else lib)
        jname = name
    jnum = jax_get_numerics(jname, None if jname == "exact" else jlib)
    want = np.asarray(jax.jit(lambda v: jnum.softmax(v, axis=axis))(
        jnp.asarray(x)))
    got = num.softmax(torch.from_numpy(x), axis=axis).numpy()
    assert got.dtype == np.float32
    if name == "exact":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    else:
        _assert_close(got, want, _tol(lib, "float32"))


# -- the CUDA kernels' launch shape, operands and sum order (no card) --------

def _vendored(kind):
    return TableDesign.from_dict(json.loads(
        (TABLES_DIR / f"{kind}_{DEFAULT_TABLE_KEY}.json").read_text()))


@pytest.fixture(scope="module")
def seg_libs():
    """The default library with its exp2neg and recip slots segmented (ROM
    v2), in both packages; the other slots uniform."""
    port = InterpLibrary.from_designs(
        [explore_segmented(spec_for(k), max_depth=6, engine="batched",
                           device="cpu") if k in ("exp2neg", "recip")
         else _vendored(k) for k in DEFAULT_LIBRARY_KINDS],
        DEFAULT_LIBRARY_KINDS, device="cpu")
    ref = default_explorer().compile_segmented(segment=("exp2neg", "recip"))
    assert port.segmented_kinds == ("exp2neg", "recip")
    np.testing.assert_array_equal(port.coeffs.numpy(), np.asarray(ref.coeffs))
    return port, ref


@pytest.mark.parametrize("rows,d,itemsize,vector,want", [
    (4, 64, 4, True, (1, 16, 1, 8)),        # DeepSeekMoE router, decode
    (511, 64, 4, True, (1, 16, 1, 8)),      # router, 511-token prefill
    (8, 4096, 2, True, (1, 512, 1, 1)),     # a wide bf16 row
    (37, 1000, 2, True, (1, 128, 1, 1)),    # the per-table phase's tails
    (16384, 512, 4, True, (1, 32, 4, 4)),   # a 512-token prefill's scores
    (16384, 512, 4, False, (0, 128, 4, 1)),
    (1, 8192, 2, True, (1, 512, 2, 1)),
    (2, 32768, 4, True, (1, 512, 8, 1)),    # two passes of 4096 vectors
    (3, 4095, 2, False, (0, 512, 8, 1)),    # masked: 4095 elements
    (5, 33, 2, False, (0, 64, 1, 2)),
    (3, 300, 4, True, (1, 128, 1, 1)),      # 75 chunks: 128 threads
    (4, 8, 4, True, (1, 2, 1, 64)),         # rows of 2 vectors
    (3, 1, 2, False, (0, 1, 1, 128)),
])
def test_launch_shape(rows, d, itemsize, vector, want):
    """Threads per row from D, a power of two: one thread a chunk up to
    512 threads (rows of at most 16 chunks share a warp), then up to 8
    chunks (longer rows take passes); four chunks a thread where the call
    would take more threads than the card holds; blocks of 128 threads or
    one row."""
    assert launch_shape(rows, d, itemsize, vector) == want


def test_launch_shape_refuses_bad_thread_counts():
    for tpr in (0, 3, 24, 48, 96, 2048):
        with pytest.raises(ValueError, match="threads per row"):
            launch_shape(4, 4096, 2, True, tpr)
    with pytest.raises(ValueError, match="at most 512"):
        launch_shape(4, 1 << 16, 2, True, 1024)  # 8 vectors a thread
    with pytest.raises(ValueError, match="at most 512"):
        launch_shape(4, 32768, 4, True, 1024)  # 8 float32 vectors
    assert launch_shape(4, 4096, 2, True, 128) == (1, 128, 4, 1)
    assert launch_shape(4, 64, 4, True, 4) == (1, 4, 4, 32)
    assert launch_shape(4, 64, 4, True, 32) == (1, 32, 1, 4)


def test_vector_body_needs_whole_vectors_and_aligned_rows():
    """The vector body takes D a multiple of 8 bf16 (4 f32) and 16-byte
    aligned operands; a row view at an odd offset, or D = 4095, takes the
    masked body."""
    x = torch.zeros(3, 4096, dtype=torch.bfloat16)
    assert vector_ok(x, torch.empty_like(x))
    flat = torch.zeros(3 * 4096 + 1, dtype=torch.bfloat16)
    view = flat[1:].view(3, 4096)  # contiguous rows at a 2-byte offset
    assert view.is_contiguous() and not vector_ok(view,
                                                  torch.empty_like(view))
    odd = torch.zeros(3, 4095, dtype=torch.bfloat16)
    assert not vector_ok(odd, torch.empty_like(odd))
    f = torch.zeros(4, 64)
    assert vector_ok(f, torch.empty_like(f))
    assert not vector_ok(torch.zeros(4, 66), torch.empty(4, 66))


@pytest.mark.parametrize("entry", ["softmax_lib", "softmax_tab"])
@pytest.mark.parametrize("case,err,match", [
    ("float16", TypeError, "float32 or bfloat16"),
    ("float64", TypeError, "float32 or bfloat16"),
    ("rank3", ValueError, "rows, D"),
    ("body", ValueError, "body"),
    ("tpr", ValueError, "threads per row"),
    ("vector_body", ValueError, "vector body"),
    ("lut_1024", ValueError, "at most 512"),
    ("cpu", ValueError, "CUDA tensor"),
])
def test_wrapper_refuses(entry, case, err, match, libs, monkeypatch):
    """The CUDA wrappers check dtype, rank, body, threads per row, the
    table of outputs' row width and the device before anything is built or
    launched (here on the CPU, where a
    build would fail: ``build.load`` is made to raise)."""
    def no_build():
        raise AssertionError("built before refusing")

    monkeypatch.setattr(build, "load", no_build)
    x, kw = torch.zeros(4, 64), {}
    if case in ("float16", "float64"):
        x = x.to(getattr(torch, case))
    elif case == "rank3":
        x = torch.zeros(2, 4, 64)
    elif case == "body":
        kw = {"body": "scalar"}
    elif case == "tpr":
        kw = {"tpr": 48}
    elif case == "vector_body":
        x, kw = torch.zeros(4, 33), {"body": "vector"}
    elif case == "lut_1024":
        kw = {"tpr": 1024, "lut": True}
    n0 = dict(build.LAUNCHES)
    with pytest.raises(err, match=match):
        if entry == "softmax_lib":
            softmax_lib_cuda(x, libs[0], **kw)
        else:
            softmax_tab_cuda(x, _vendored("exp2neg"), _vendored("recip"),
                             **kw)
    assert build.LAUNCHES == n0


def _jax_row_sums(x, jlib):
    """The reference's row sums: ``_softmax_body``'s lines up to
    ``s = jnp.sum(e)``, with its table read (``_lut_rom``) and exp glue
    (``_table_exp_neg``, the same lines), in jnp on the CPU."""
    em = jax_lib_meta(jlib, "exp2neg")
    rom, r_max = jlib.coeffs.reshape(-1, 3), jlib.coeffs.shape[1]
    xf = jnp.asarray(x, jnp.float32)
    m = jnp.max(xf, axis=-1, keepdims=True)
    t = jnp.minimum((m - xf) * LOG2E, 126.0)
    e = _table_exp_neg(t, lambda c: _lut_rom(c, rom, fid=em["fid"],
                                             r_max=r_max, **em["eval"]), em)
    return np.asarray(jnp.sum(e, axis=-1))


def _recip_codes(s, rb):
    """The reciprocal table's codes of row sums s > 0 (the IEEE-754
    mantissa rounded to rb bits, clamped), as ``_softmax_body`` takes
    them."""
    bits = np.asarray(s, np.float32).view(np.uint32).astype(np.int64)
    mant = bits & ((1 << 23) - 1)
    return np.minimum((mant + (1 << (23 - rb - 1))) >> (23 - rb),
                      (1 << rb) - 1)


@pytest.mark.parametrize("lib_name", ["uniform", "segmented"])
@pytest.mark.parametrize("d", [64, 1000, 4096])
def test_kernel_sum_order_moves_recip_code_by_at_most_one(d, lib_name, libs,
                                                          seg_libs):
    """The kernels' row sum in their order (``kernel_row_sum``, at the
    launch shapes of the float32 and bf16 vector bodies and of the masked
    body) against the reference's: the exp codes and so the terms e are
    the plain version's, bitwise (the codes equal the reference's); the
    reciprocal's code is within one of the reference's, so the kernels'
    outputs are within one recip-table step of the plain version's."""
    lib, jlib = libs if lib_name == "uniform" else seg_libs
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((24, d)) * rng.uniform(0.1, 6.0, (24, 1))
         ).astype(np.float32)
    xt = torch.from_numpy(x)
    em = lib_meta(lib, "exp2neg")
    codes, e = softmax_exp(xt, lib.coeffs, em)
    np.testing.assert_array_equal(codes.numpy(),
                                  _jax_exp_codes(x, em["in_bits"]))
    rb = lib.meta("recip").in_bits
    want = _recip_codes(_jax_row_sums(x, jlib), rb)
    plain = fused_softmax_lib_ref(xt, lib.coeffs, em, lib_meta(lib, "recip"))
    for itemsize, vector in ((4, True), (2, True), (4, False)):
        _, tpr, _, _ = launch_shape(24, d, itemsize, vector)
        vec = 16 // itemsize if vector else 1
        got = _recip_codes(kernel_row_sum(e, vec, tpr).numpy(), rb)
        assert np.abs(got - want).max() <= 1, (itemsize, vector, tpr)
        # the kernels' outputs from this sum, against the plain version's
        out = kernel_order_softmax(xt, lib.coeffs, lib.coeffs, em,
                                   lib_meta(lib, "recip"), vec, tpr)
        _assert_close(out.numpy(), plain.numpy(), 2.0 ** -(rb - 1))


@pytest.mark.parametrize("vec,tpr", [(4, 16), (8, 256), (1, 64), (4, 512),
                                     (2, 1), (1, 1024)])
def test_kernel_row_sum_is_the_shuffle_order(vec, tpr):
    """``kernel_row_sum`` on sums that are exact in any order (small
    integers) equals the plain sum, and on rows of one nonzero term returns
    that term, wherever it sits (every element is some thread's)."""
    rng = np.random.default_rng(tpr)
    d = vec * tpr * 3 - vec
    e = torch.from_numpy(rng.integers(0, 8, (5, d)).astype(np.float32))
    assert torch.equal(kernel_row_sum(e, vec, tpr), e.sum(-1))
    one = torch.zeros(d, d)
    one[torch.arange(d), torch.arange(d)] = 0.375
    assert torch.equal(kernel_row_sum(one, vec, tpr), torch.full((d,), 0.375))
