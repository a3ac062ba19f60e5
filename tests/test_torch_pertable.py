"""The per-table path: ``approx_softmax_fused``, ``approx_rmsnorm_fused`` and
``attention_fused`` (each table from its own ``TableDesign``), the
module-level ``approx_*`` numerics and the unbound ``InterpNumerics``,
against the reference, over three design sets: the default 12-bit R6
designs, the 12-bit R5 ones and 10-bit ones, which the port generates into
a fresh cache directory and hands to the reference through ``to_dict`` /
``from_dict``, so both packages compute on the same tables. The default
sessions of both packages (what ``get_table`` and the unbound backends
read) run on a fresh cache directory too: nothing is written to
``artifacts/tables``.

Tolerances:
* exp2neg table codes: bit-exact (they come from the row max and one
  element in the same float32 order in both packages).
* softmax outputs: where the reciprocal's code and exponent agree too, the
  reference's float32 ``exp2`` of the two integers (inexact on the CPU, by
  up to ~1e-6 relative at these exponents, as measured in the test; the
  port takes exact powers of two) plus three float32 roundings; elsewhere
  the row sum's order moved that code, within the relative
  ``softmax_ulp_bound`` of the two tables. bf16 outputs add one rounding
  (2^-7 relative). An absolute 1e-30 covers 2^-126-scaled terms the
  reference flushes to zero.
* RMSNorm: rtol 1e-6 where mean(x^2) agrees bitwise, else 2 rsqrt-table
  ulps, 2 * 2^-(out_bits - 1) relative (as ``test_torch_rmsnorm.py``).
* attention: two unchunked versions differ by one table-code flip,
  |diff| <= softmax_ulp_bound * max|v|; against a chunked kernel each
  running correction is a table read too: (n_chunks + 2) * bound * max|v|
  (as ``test_torch_flashattn.py``). The tile-by-tile twin against the
  reference's kernel with the same tiles: one flip at most, mean error at
  float level.
* the module-level ops: the reference's CPU exp2 error at the power of two
  each glue scales by, plus one float32 rounding (activations: rtol 1e-6);
  atol 1e-30 for its flushed subnormals.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.table import TableDesign as JaxTableDesign
from repro.kernels.flashattn.kernel import flash_attention
from repro.kernels.flashattn.ops import attention_fused as jax_attention
from repro.kernels.interp.ref import interp_eval_ref as jax_interp_eval_ref
from repro.kernels.rmsnorm.ops import approx_rmsnorm_fused as jax_rmsnorm
from repro.kernels.softmax.ops import _meta as jax_meta
from repro.kernels.softmax.ops import approx_softmax_fused as jax_softmax
from repro.models import transformer as jtf
from repro.numerics import ops as jops
from repro_torch import api
from repro_torch.api import Explorer, ExploreConfig, InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.table import CoeffMeta, TableDesign
from repro_torch.kernels.flashattn.kernel import query_tile
from repro_torch.kernels.flashattn.ops import attention_fused
from repro_torch.kernels.flashattn.ref import (flash_attention_chunked_ref,
                                               flash_attention_lib_chunked_ref)
from repro_torch.kernels.interp.ops import lib_meta
from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_fused
from repro_torch.kernels.rmsnorm.ref import (fused_rmsnorm_lib_ref,
                                             fused_rmsnorm_ref)
from repro_torch.kernels.softmax.ops import _meta, approx_softmax_fused
from repro_torch.kernels.softmax.ref import (fused_softmax_lib_ref,
                                             fused_softmax_ref, softmax_exp)
from repro_torch.models import transformer as tf
from repro_torch.numerics import ops
from repro_torch.numerics import registry

KINDS = ("exp2neg", "recip", "rsqrt")
SETS = ("R6", "R5", "10b")
LOG2E = 1.4426950408889634
EPS = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fresh_default_sessions(tmp_path_factory):
    """Both packages' default Explorers on fresh cache directories for this
    module (the defaults generate in milliseconds), restored after."""
    old, jold = api.default_explorer(), jax_api.default_explorer()
    api.set_default_explorer(Explorer(ExploreConfig(
        device="cpu", cache_dir=str(tmp_path_factory.mktemp("port")))))
    jax_api.set_default_explorer(jax_api.Explorer(jax_api.ExploreConfig(
        cache_dir=str(tmp_path_factory.mktemp("ref")))))
    yield
    api.set_default_explorer(old)
    jax_api.set_default_explorer(jold)


@pytest.fixture(scope="module")
def designs(tmp_path_factory):
    """set -> kind -> (port design, reference design) on the same table:
    the default R6 designs, R5 and 10-bit, generated by the port."""
    gen = Explorer(ExploreConfig(device="cpu",
                                 cache_dir=str(tmp_path_factory.mktemp("t"))))
    kw = {"R6": {}, "R5": {"lookup_bits": 5}, "10b": {"bits": 10}}
    out = {}
    for name in SETS:
        out[name] = {}
        for kind in KINDS:
            d = gen.get_table(kind, **kw[name])
            out[name][kind] = (d, JaxTableDesign.from_dict(d.to_dict()))
    return out


def _wide_design():
    """A synthetic design whose coefficients exceed int32."""
    rng = np.random.default_rng(3)
    meta = CoeffMeta(40, 0, True)
    return TableDesign("wide", 12, 20, 4, 30, 2, 1, 0,
                       rng.integers(-2**20, 2**20, 16),
                       rng.integers(-2**36, 2**36, 16),
                       rng.integers(2**45, 2**46, 16), meta, meta, meta)


def _both(x, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    xj = jnp.asarray(x).astype(dtype)
    return torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype)), xj


# -- softmax -----------------------------------------------------------------

def _logits(shape, seed):
    """Router-like logits; row 0 is constant (every term ties) and row 1
    spreads past the t = 126 clamp of the exp table."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 8.0, shape[:-1] + (1,))
         ).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.75
    flat[1, ::3] = -200.0
    return x


def _exp2_err(e: np.ndarray) -> np.ndarray:
    """Relative error of the reference's CPU float32 ``exp2`` at the
    integers -e (exact powers of two in the port)."""
    got = np.asarray(jnp.exp2(-jnp.asarray(e, jnp.float32)), np.float64)
    exact = np.ldexp(1.0, -e.astype(np.int64))
    return np.abs(got - exact) / exact


def _recip_split(s, rb):
    """(code, exponent) of the reciprocal's IEEE split of row sums s."""
    bits = np.asarray(s, np.float32).view(np.uint32).astype(np.int64)
    mant = bits & ((1 << 23) - 1)
    code = np.clip((mant + (1 << (23 - rb - 1))) >> (23 - rb), 0,
                   (1 << rb) - 1)
    return code, ((bits >> 23) & 255) - 127


def _jax_glue(x, jed, jrd):
    """The reference ``fused_softmax_ref``'s exp2neg codes, floor(t) and
    row-sum split (code, exponent) on float32 ``x`` (its first lines, in
    jnp)."""
    em = jax_meta(jed)
    xf = jnp.asarray(x, jnp.float32)
    m = jnp.max(xf, axis=-1, keepdims=True)
    t = jnp.minimum((m - xf) * LOG2E, 126.0)
    n = jnp.floor(t)
    eb = em["in_bits"]
    codes = jnp.clip(jnp.round((t - n) * (1 << eb)).astype(jnp.int32), 0,
                     (1 << eb) - 1)
    tab = jax_interp_eval_ref(codes, jed.device_coeffs(checked=True),
                              **em["eval"]).astype(jnp.float32)
    s = jnp.sum(tab * (2.0 ** -em["out_bits"]) * jnp.exp2(-n), -1)
    return (np.asarray(codes), np.asarray(n),
            *_recip_split(s, jrd.in_bits))


def _check_softmax(got, want, x32, ed, rd, jed, jrd, dtype):
    """Exp codes bitwise. Rows whose reciprocal split (code and exponent)
    agrees too differ only by the reference's inexact exp2 of floor(t) and
    of the exponent, plus three float32 roundings; the other rows, where the
    row sum's order moved the code, stay within the table bound."""
    d = x32.shape[-1]
    codes, e = softmax_exp(torch.from_numpy(x32.reshape(-1, d)),
                           ed.device_coeffs("cpu"), _meta(ed))
    jcodes, n, jrcode, jexpo = _jax_glue(x32.reshape(-1, d), jed, jrd)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    rcode, expo = _recip_split(e.sum(-1).numpy(), rd.in_bits)
    same = (rcode == jrcode) & (expo == jexpo)
    assert same.mean() > 0.5
    bf16 = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    got = np.asarray(got, np.float32).reshape(-1, d)
    want = np.asarray(want, np.float32).reshape(-1, d)
    rtol = _exp2_err(n) + _exp2_err(jexpo)[:, None] + 3 * 2.0 ** -24 + bf16
    assert np.all((np.abs(got - want) <= rtol * np.abs(want) + 1e-30)[same])
    rel = ops.softmax_ulp_bound(ed, rd) + bf16
    assert np.all(np.abs(got - want) <= rel * np.abs(want) + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dset", SETS)
def test_softmax_plain_matches_reference_oracle(dset, dtype, designs):
    (ed, jed), (rd, jrd) = designs[dset]["exp2neg"], designs[dset]["recip"]
    shape = (6, 5, 96)
    xt, xj = _both(_logits(shape, SETS.index(dset)), dtype)
    got = approx_softmax_fused(xt, ed, rd)
    assert got.dtype == xt.dtype and tuple(got.shape) == shape
    want = jax_softmax(xj, jed, jrd, use_kernel=False).astype(jnp.float32)
    _check_softmax(got.float().numpy(), want, xt.float().numpy(), ed, rd,
                   jed, jrd, dtype)


@pytest.mark.parametrize("dset", SETS)
def test_softmax_plain_matches_reference_interpret_kernel(dset, designs):
    (ed, jed), (rd, jrd) = designs[dset]["exp2neg"], designs[dset]["recip"]
    x = _logits((16, 128), 7)
    want = jax_softmax(jnp.asarray(x), jed, jrd, use_kernel=True,
                       interpret=True)
    got = approx_softmax_fused(torch.from_numpy(x), ed, rd)
    _check_softmax(got.numpy(), want, x, ed, rd, jed, jrd, "float32")


# -- rmsnorm -----------------------------------------------------------------

def _rms_inputs(seed, rows=8, d=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32) * \
        rng.uniform(0.05, 20.0, (rows, 1)).astype(np.float32)
    # rows of small powers of two: x^2 and every partial sum are exact, so
    # both frameworks agree on mean(x^2) bitwise whatever their sum order
    x[:3] = rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], (3, d))
    return x, rng.uniform(0.5, 1.5, d).astype(np.float32)


def _check_rms(got, want, x32, rd, bf16=0.0):
    ms_t = ((torch.from_numpy(x32) ** 2).mean(-1) + EPS).numpy()
    ms_j = np.asarray(jnp.mean(jnp.asarray(x32) ** 2, -1) + EPS)
    same = ms_t == ms_j
    assert same[:3].all()
    np.testing.assert_allclose(got[same], want[same], rtol=1e-6 + bf16)
    np.testing.assert_allclose(got, want, atol=1e-30,
                               rtol=2 * 2.0 ** -(rd.out_bits - 1) + bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dset", SETS)
def test_rmsnorm_plain_matches_reference_oracle(dset, dtype, designs):
    rd, jrd = designs[dset]["rsqrt"]
    x, gamma = _rms_inputs(SETS.index(dset))
    xt, xj = _both(x, dtype)
    got = approx_rmsnorm_fused(xt, torch.from_numpy(gamma), rd, EPS)
    assert got.dtype == xt.dtype
    want = np.asarray(jax_rmsnorm(xj, jnp.asarray(gamma), jrd, EPS,
                                  use_kernel=False).astype(jnp.float32))
    _check_rms(got.float().numpy(), want, xt.float().numpy(), rd,
               2.0 ** -7 if dtype == "bfloat16" else 0.0)


@pytest.mark.parametrize("dset", SETS)
def test_rmsnorm_plain_matches_reference_interpret_kernel(dset, designs):
    rd, jrd = designs[dset]["rsqrt"]
    x, gamma = _rms_inputs(11, rows=16, d=128)
    want = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(gamma), jrd,
                                  EPS, use_kernel=True, interpret=True))
    got = approx_rmsnorm_fused(torch.from_numpy(x), torch.from_numpy(gamma),
                               rd, EPS).numpy()
    _check_rms(got, want, x, rd)


# -- attention ---------------------------------------------------------------

def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dset", SETS)
def test_attention_plain_matches_reference(dset, designs):
    """Against the reference's unchunked oracle (``use_kernel=False``) and
    its chunked kernel in interpret mode (one 128-key chunk), N = 2, S = 128,
    D = 64."""
    (ed, jed), (rd, jrd) = designs[dset]["exp2neg"], designs[dset]["recip"]
    q, k, v = _qkv(SETS.index(dset), 1, 128, 2, 64)
    got = attention_fused(*(torch.from_numpy(a) for a in (q, k, v)),
                          exp_design=ed, recip_design=rd).numpy()
    jq = [jnp.asarray(a) for a in (q, k, v)]
    oracle = np.asarray(jax.jit(functools.partial(
        jax_attention, use_kernel=False, exp_design=jed,
        recip_design=jrd))(*jq))
    kern = np.asarray(jax_attention(*jq, exp_design=jed, recip_design=jrd,
                                    use_kernel=True, interpret=True))
    bound = ops.softmax_ulp_bound(ed, rd) * np.abs(v).max()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=bound)
    np.testing.assert_allclose(got, kern, rtol=0, atol=(2 + 2) * bound)


@pytest.mark.parametrize("causal", [True, False])
def test_tile_twin_matches_reference_kernel_10bit(causal, designs):
    """The tile-by-tile per-table twin against the reference's interpret-mode
    ``flash_attention`` with the same tiles (32 queries, 32 keys) on the
    10-bit designs. Their exp2neg table has tab(0) = 8191 at 13 bits, so a
    key tile that leaves the running max unchanged still scales l and the
    accumulator: the twin matches only because it skips exactly the tiles
    the kernel skips (those strictly above the diagonal). A twin that runs
    every tile differs at table level on the causal prefill."""
    (ed, jed), (rd, jrd) = designs["10b"]["exp2neg"], designs["10b"]["recip"]
    assert int(ed.eval_int(np.array([0]))[0]) == 8191
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((2, 128, 16)).astype(np.float32)
               for _ in range(3))
    kern = np.asarray(flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jed.device_coeffs(checked=True),
        jrd.device_coeffs(checked=True), jax_meta(jed), jax_meta(jrd),
        causal=causal, block_q=32, block_k=32, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = flash_attention_chunked_ref(*t, ed, rd, causal=causal, block_k=32,
                                      block_q=32).numpy()
    err = np.abs(got - kern)
    assert err.max() <= ops.softmax_ulp_bound(ed, rd) * np.abs(v).max()
    assert err.mean() <= 1e-5
    every_tile = flash_attention_chunked_ref(*t, ed, rd, causal=causal,
                                             block_k=32).numpy()
    if causal:
        assert np.abs(every_tile - kern).mean() > 1e-5
    else:  # no tile is dead: the two twins are the same computation
        np.testing.assert_array_equal(every_tile, got)


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("case", ["decode", "dead_splits"])
def test_split_twin_matches_reference_oracle_10bit(case, splits, designs):
    """The per-table tile twin with key splits on the 10-bit designs (tab(0)
    = 8191: each split's combine factor is a real rescale) against the
    reference's unfused per-table oracle, within (n_tiles + 2) * bound *
    max|v|: a non-causal decode query over 8 tiles, and 4 causal queries at
    positions 0-3 (top-left), for which every split past the first is
    wholly dead."""
    from repro.kernels.flashattn.ref import flash_attention_ref as jax_oracle

    (ed, jed), (rd, jrd) = designs["10b"]["exp2neg"], designs["10b"]["recip"]
    sq, causal = (1, False) if case == "decode" else (4, True)
    rng = np.random.default_rng(23)
    q = rng.standard_normal((2, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 16)).astype(np.float32)
            for _ in range(2))
    got = flash_attention_chunked_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), ed, rd, causal=causal,
        block_k=8, block_q=query_tile(sq, 1, 16), kv_splits=splits).numpy()
    want = np.asarray(jax_oracle(*(jnp.asarray(a) for a in (q, k, v)), jed,
                                 jrd, causal=causal))
    tol = (8 + 2) * ops.softmax_ulp_bound(ed, rd) * np.abs(v).max()
    assert np.abs(got - want).max() <= tol


def test_attention_fused_takes_expanded_heads_only(designs):
    q = torch.zeros(1, 4, 4, 8)
    kv = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="expand GQA"):
        attention_fused(q, kv, kv)


# -- per-table == library on the default designs -------------------------------

def test_per_table_plain_equals_library_plain_r6(designs):
    """The default library packs the R6 designs: the per-table plain
    versions and the library-bound ones read the same rows and run the same
    glue, bitwise (the reference's own invariant)."""
    lib = InterpLibrary.default_library("cpu")
    d = {k: designs["R6"][k][0] for k in KINDS}
    for k in KINDS:  # the vendored tables the library packs
        assert torch.equal(d[k].device_coeffs("cpu"),
                           lib.coeffs[lib.func_id(k), :len(d[k].a)])
    co = {k: d[k].device_coeffs("cpu") for k in KINDS}
    x = torch.from_numpy(_logits((9, 200), 3))
    assert torch.equal(
        fused_softmax_ref(x, co["exp2neg"], co["recip"], _meta(d["exp2neg"]),
                          _meta(d["recip"])),
        fused_softmax_lib_ref(x, lib.coeffs, lib_meta(lib, "exp2neg"),
                              lib_meta(lib, "recip")))
    xr, gamma = (torch.from_numpy(a) for a in _rms_inputs(4))
    assert torch.equal(
        fused_rmsnorm_ref(xr, gamma, co["rsqrt"], _meta(d["rsqrt"])),
        fused_rmsnorm_lib_ref(xr, gamma, lib.coeffs, lib_meta(lib, "rsqrt")))
    q, k, v = (torch.from_numpy(a[0].transpose(1, 0, 2).copy())
               for a in _qkv(5, 1, 40, 2, 16))
    tq = query_tile(40, 1, 16)
    pos = torch.arange(40, dtype=torch.int32).expand(2, 40)
    assert torch.equal(
        flash_attention_chunked_ref(q, k, v, d["exp2neg"], d["recip"],
                                    block_q=tq),
        flash_attention_lib_chunked_ref(q, k, v, pos, pos, lib.coeffs,
                                        lib_meta(lib, "exp2neg"),
                                        lib_meta(lib, "recip"), block_q=tq))


def test_wide_design_raises():
    """A design that exceeds int32 cannot be a kernel operand: the fused ops
    raise, as the reference's ``device_coeffs(checked=True)``."""
    wide = _wide_design()
    assert not wide.fits_int32
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="exceed int32"):
        approx_softmax_fused(x, exp_design=wide)
    with pytest.raises(ValueError, match="exceed int32"):
        approx_softmax_fused(x, recip_design=wide)
    with pytest.raises(ValueError, match="exceed int32"):
        approx_rmsnorm_fused(x, torch.ones(8), design=wide)


# -- module-level numerics -----------------------------------------------------

SWEEPS = {
    "exp_neg": np.concatenate([-np.geomspace(1e-6, 200.0, 400), [0.0]]),
    "recip_pos": np.geomspace(1e-20, 1e20, 401),
    "rsqrt_pos": np.geomspace(1e-20, 1e20, 401),
    "act": np.concatenate([np.linspace(-10.0, 10.0, 403), [-8.0, 8.0]]),
}
APPROX = {"exp_neg": "exp_neg", "recip_pos": "recip_pos",
          "rsqrt_pos": "rsqrt_pos", "silu": "act", "sigmoid": "act",
          "softplus": "act", "gelu": "act", "tanh": "act"}


def _pow2_rtol(fn: str, x: np.ndarray) -> np.ndarray:
    """The tolerance of a module-level op against the reference: the
    reference's CPU exp2 error at the integer power of two the glue scales
    by (exact in the port) plus one float32 rounding; activations have no
    such scale."""
    if fn == "exp_neg":
        t = np.minimum(np.maximum(-x, 0).astype(np.float32)
                       * np.float32(LOG2E), np.float32(126.0))
        k = np.floor(t)
    elif fn in ("recip_pos", "rsqrt_pos"):
        _, e = np.frexp(x.astype(np.float32))
        k = e - 1 if fn == "recip_pos" else np.where(e % 2, e - 1, e - 2) // 2
    else:
        return np.full(x.shape, 1e-6)
    return _exp2_err(k) + 2.0 ** -24


@pytest.mark.parametrize("name", sorted(APPROX))
def test_module_level_approx_matches_reference(name):
    """Each ``approx_*`` on its default table (``get_table``) over a sweep
    of its domain."""
    x = SWEEPS[APPROX[name]].astype(np.float32)
    got = getattr(ops, f"approx_{name}")(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jops, f"approx_{name}")(jnp.asarray(x)))
    assert np.all(np.abs(got - want) <= _pow2_rtol(APPROX[name], x)
                  * np.abs(want) + 1e-30)


@pytest.mark.parametrize("dset", ["R5", "10b"])
def test_module_level_approx_with_designs(dset, designs):
    """exp / recip / rsqrt and the composites on explicit designs."""
    (ed, jed), (rd, jrd), (sd, jsd) = (designs[dset][k] for k in KINDS)
    for fn, d, jd in (("exp_neg", ed, jed), ("recip_pos", rd, jrd),
                      ("rsqrt_pos", sd, jsd)):
        x = SWEEPS[fn].astype(np.float32)
        got = getattr(ops, f"approx_{fn}")(torch.from_numpy(x), d).numpy()
        want = np.asarray(getattr(jops, f"approx_{fn}")(jnp.asarray(x), jd))
        assert np.all(np.abs(got - want) <= _pow2_rtol(fn, x) * np.abs(want)
                      + 1e-30)
    x = _logits((4, 64), 9)
    got = ops.approx_softmax(torch.from_numpy(x), -1, ed, rd).numpy()
    want = np.asarray(jops.approx_softmax(jnp.asarray(x), -1, jed, jrd))
    np.testing.assert_allclose(got, want, rtol=ops.softmax_ulp_bound(ed, rd),
                               atol=1e-30)
    x, gamma = _rms_inputs(2)
    got = ops.approx_rmsnorm(torch.from_numpy(x), torch.from_numpy(gamma),
                             EPS, sd).numpy()
    want = np.asarray(jops.approx_rmsnorm(jnp.asarray(x), jnp.asarray(gamma),
                                          EPS, jsd))
    _check_rms(got, want, x, sd)


def test_softmax_ulp_bound_defaults_and_designs(designs):
    assert ops.softmax_ulp_bound() == jops.softmax_ulp_bound()
    for dset in SETS:
        (ed, jed), (rd, jrd) = (designs[dset][k] for k in ("exp2neg",
                                                           "recip"))
        assert ops.softmax_ulp_bound(ed, rd) == jops.softmax_ulp_bound(jed,
                                                                       jrd)
        assert ops.softmax_ulp_bound(ed) == jops.softmax_ulp_bound(jed)


def test_registry_shim():
    """``numerics.registry.get_table`` is the default session's table and
    ``DEFAULTS`` the config's, as in the reference."""
    from repro.numerics import registry as jregistry
    from repro_torch.api.config import DEFAULTS

    assert registry.get_table("recip") is api.get_table("recip")
    assert registry.DEFAULTS is DEFAULTS
    assert registry.DEFAULTS == jregistry.DEFAULTS
    assert registry.get_table("rsqrt").to_dict() == \
        jregistry.get_table("rsqrt").to_dict()


def test_get_numerics_unbound():
    """``"interp"`` without a library resolves tables lazily; the fused
    lowering without one raises the reference's error."""
    num = ops.get_numerics("interp")
    assert type(num) is ops.InterpNumerics and num.library is None
    for args in (("interp-fused",), ("interp", None, True)):
        with pytest.raises(ValueError) as got:
            ops.get_numerics(*args)
        with pytest.raises(ValueError) as want:
            jops.get_numerics(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("op", ["softmax", "rmsnorm", "silu", "exp_neg",
                                "recip_pos", "rsqrt_pos"])
def test_unbound_interp_ops_match_reference(op):
    num, jnum = ops.get_numerics("interp"), jops.get_numerics("interp")
    x, gamma = _rms_inputs(6, rows=4, d=64)
    if op in ("exp_neg",):
        x = -np.abs(x)
    elif op in ("recip_pos", "rsqrt_pos"):
        x = np.abs(x) + 1e-3
    args, jargs = [torch.from_numpy(x)], [jnp.asarray(x)]
    if op == "rmsnorm":
        args.append(torch.from_numpy(gamma))
        jargs.append(jnp.asarray(gamma))
    got = getattr(num, op)(*args).numpy()
    want = np.asarray(getattr(jnum, op)(*jargs))
    if op == "softmax":
        np.testing.assert_allclose(got, want, atol=1e-30,
                                   rtol=ops.softmax_ulp_bound())
    elif op == "rmsnorm":
        _check_rms(got, want, x, registry.get_table("rsqrt"))
    else:
        rtol = _pow2_rtol("act" if op == "silu" else op, x)
        assert np.all(np.abs(got - want) <= rtol * np.abs(want) + 1e-30)


def test_smoke_yi_prefill_unbound_interp_matches_reference():
    """The ``yi_6b`` smoke prefill under the unbound ``get_numerics("interp")``
    of both packages (the reference's parameters carried over): logits
    within the model tests' interp tolerance, 4 * 2^-12 * max|logit|, and
    the same greedy tokens wherever the reference's top-2 gap is clear."""
    jcfg, cfg = jax_smoke_config("yi_6b"), get_smoke_config("yi_6b")
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13)
                                             ).astype(np.int32)
    jlog, _, _ = jax.jit(functools.partial(
        jtf.prefill, cfg=jcfg, numerics=jops.get_numerics("interp"),
        cache_len=32))(jparams, jnp.asarray(toks))
    tlog, _ = tf.prefill(params, torch.from_numpy(toks).long(), cfg,
                         ops.get_numerics("interp"), 32)
    jlog = np.asarray(jlog)
    tol = 4 * 2.0 ** -12 * np.abs(jlog).max()
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0, atol=tol)
    ref = jlog.reshape(-1, jlog.shape[-1])
    got = tlog.numpy().reshape(-1, jlog.shape[-1])
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    assert clear.any()
    np.testing.assert_array_equal(ref.argmax(-1)[clear], got.argmax(-1)[clear])


def test_default_explorer_tables_agree():
    """The unbound backends of both packages read the same default tables."""
    for kind in ("exp2neg", "recip", "rsqrt", "silu"):
        assert registry.get_table(kind).to_dict() == \
            jax_api.default_explorer().get_table(kind).to_dict()
