"""Card-only tests of the port: each CUDA kernel against its plain version
at the main path's widths, and the smoke model and engine through the
kernels. Marked ``gpu``; without a card they skip. Run on a machine with an
H100 as ``pytest -m gpu tests/test_torch_gpu.py`` (this file imports neither
jax nor repro, so it runs where only the port is installed).

Tolerances:
* library_eval: bit-exact (integer datapath).
* rmsnorm_lib: the kernel reduces mean(x^2) in another order than torch, so
  a code may move by one step: 2 rsqrt-table ulps (2 * 2^-(out_bits-1)
  relative) plus one output rounding (2^-7 relative in bf16).
* flash_attn_lib: the kernel is chunked (64-key tiles) and the plain
  version is not; each running correction is a table read, so
  |diff| <= (n_tiles + 2) * softmax_ulp_bound * max|v|, plus one bf16
  rounding of p and of the output (2^-7 * (max|v| + |out|)) in bf16.
  Against the tile-by-tile twin with the same 64-key tiles, the kernel's
  query tiles (so the same dead tiles are skipped) and its key splits (the
  same table-corrected combine) only float reassociation remains, and in
  bf16 the product of q*scale split into bf16 hi + lo planes (16 of its 24
  bits): one table-code flip (softmax_ulp_bound * max|v|) plus one output
  rounding (2^-8 * |out| in bf16).
* softmax_lib: the exp terms e come from the row max and one element, so
  they are bit-exact; only the row sum's order differs, which can move the
  reciprocal's code by one step: relative 2^-(recip in_bits - 1), plus one
  output rounding (2^-7 relative) in bf16. Against the twin with the
  kernels' sum order at the wrapper's launch shape
  (``kernel_order_softmax``): bitwise, for every body and thread count.
* library_walk and rom_eval: bit-exact, on the uniform and the segmented
  (ROM v2) default library; the fused kernels on the segmented library at
  the tolerances above.
* interp_eval, the envelope kernels and dd_max_rows: bitwise. The
  envelope arithmetic is IEEE float32 add and subtract of integers in the
  reference's order and a quotient that equals the IEEE divide bit for bit
  (csrc/dspace.cu); dd_max_rows divides once per delta, which monotone
  rounding makes equal to a divide per pair; min / max do not depend on
  order.
* The per-table kernels (softmax_tab, rmsnorm_tab, flash_attn_tab) on the
  default R6, the vendored R5 and generated 10-bit designs, at the
  tolerances of their library twins above (with each design's own widths);
  rmsnorm_tab bitwise on rows whose mean(x^2) is exact in any order (the
  same rsqrt code); the tile-by-tile twin with the kernel's query tiles,
  and the unchunked oracle (its unfused glue one more table ulp, inside the
  (n_tiles + 2) bound). On the R6 designs each equals its library twin
  bitwise.
* The MoE experts' products (bf16 x bf16 -> float32 from cuBLAS, at full
  width) against the float32 product of the upcast operands on the card:
  within twice the float32 summation bound K * 2^-24 * (|a| @ |b|),
  elementwise (each result lies within it of the exact product, in any
  order of summation).
* The smoke models through the kernels against the plain versions:
  4 * 2^-12 * max|logit| (a few table-code flips). The MoE routing is the
  same on both paths: a recip flip scales a whole row of router
  probabilities, so the top-k order does not change.
* The bf16 train path (``loss_and_grads``, one train step, a full-width
  Yi-6B block and DeepSeekMoE MoE layer forward and backward) against the
  port on the CPU: the card's float32 sums run in cuBLAS's order and its
  transcendentals are CUDA's, and the bf16 roundings between the products
  carry those differences on as they carry the CPU's own rounding. So the
  bound is the CPU's own bf16 error: the card's loss, aux loss, output and
  every gradient within twice max |CPU bf16 - CPU float32| on the same
  bf16-valued weights (``tools/train_parity.py``), MoE routes forced to
  the CPU's after every flip is shown to be a near tie. Under interp,
  ``library_eval`` inside autograd against the plain evaluator on the
  card: the loss bitwise, every gradient within one bf16 ulp of its
  leaf's largest magnitude (autograd's index backward adds in no fixed
  order on the card).
"""
from __future__ import annotations

import functools
import json
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.api import Explorer, ExploreConfig
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.funcspec import get_spec
from repro_torch.core.table import CoeffMeta, TableDesign
from repro_torch.kernels import build
from repro_torch.kernels.dspace import kernel as dk
from repro_torch.kernels.dspace import ops as dops
from repro_torch.kernels.dspace import ref as dref
from repro_torch.kernels.flashattn.kernel import kv_splits, query_tile
from repro_torch.kernels.flashattn.ops import (attention_fused,
                                               attention_fused_library)
from repro_torch.kernels.flashattn.ref import (attention_fused_library_ref,
                                               attention_fused_ref)
from repro_torch.kernels.interp.kernel import interp_eval_cuda, rom_eval_cuda
from repro_torch.kernels.interp.ops import (library_eval, library_walk,
                                            rom_eval, table_eval)
from repro_torch.kernels.interp.ref import (interp_eval_ref,
                                            library_eval_ref,
                                            library_walk_ref)
from repro_torch.kernels.rmsnorm.ops import (approx_rmsnorm_fused,
                                             approx_rmsnorm_library)
from repro_torch.kernels.rmsnorm.ref import (approx_rmsnorm_library_ref,
                                             fused_rmsnorm_ref)
from repro_torch.kernels.softmax.kernel import (launch_shape,
                                                softmax_lib_cuda,
                                                softmax_tab_cuda, vector_ok)
from repro_torch.kernels.softmax.ops import (_meta, approx_softmax_fused,
                                             approx_softmax_library,
                                             lib_meta)
from repro_torch.kernels.softmax.ref import (approx_softmax_library_ref,
                                             fused_softmax_ref,
                                             kernel_order_softmax,
                                             softmax_exp)
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import (FusedInterpNumerics, PlainFusedNumerics,
                                      softmax_ulp_bound)
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pytest -m gpu tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def lib(dev):
    return InterpLibrary.default_library(dev)


def test_all_codes_every_kind_bit_exact(lib, dev):
    codes = torch.arange(4096, dtype=torch.int32, device=dev)
    for kind in lib.kinds:
        fid = lib.func_id(kind)
        got = lib.eval_int(codes, kind)
        want = library_eval_ref(codes, torch.full_like(codes, fid),
                                lib.coeffs, lib.meta_rows())
        assert torch.equal(got, want), kind


@pytest.mark.parametrize("shape", [(4, 1, 11008), (1, 512, 11008)])
def test_library_eval_silu_shapes(shape, lib, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(0, 4096, shape, dtype=torch.int32, device=dev,
                          generator=g)
    fids = torch.randint(0, len(lib), shape, dtype=torch.int32, device=dev,
                         generator=g)
    n0 = build.LAUNCHES["library_eval"]
    silu = lib.func_id("silu")
    assert torch.equal(library_eval(codes, silu, lib.coeffs, lib.meta_rows()),
                       library_eval_ref(codes, torch.full_like(codes, silu),
                                        lib.coeffs, lib.meta_rows()))
    assert torch.equal(library_eval(codes, fids, lib.coeffs, lib.meta_rows()),
                       library_eval_ref(codes, fids, lib.coeffs,
                                        lib.meta_rows()))
    assert build.LAUNCHES["library_eval"] == n0 + 2


# the main path's shapes (Yi-6B, DeepSeekMoE: decode, prefill), one row,
# and shapes only the masked body takes (D no multiple of the vector)
RMS_SHAPES = [(4, 4096, torch.bfloat16), (512, 4096, torch.bfloat16),
              (4, 2048, torch.bfloat16), (511, 2048, torch.bfloat16),
              (1, 4096, torch.bfloat16), (7, 1000, torch.float32),
              (3, 4095, torch.bfloat16)]
GAMMA_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("gdtype", GAMMA_DTYPES)
@pytest.mark.parametrize("rows,d,dtype", RMS_SHAPES)
def test_rmsnorm_kernel_matches_plain(rows, d, dtype, gdtype, lib, dev):
    _check_rmsnorm(rows, d, dtype, lib, dev, gdtype)


@pytest.mark.parametrize("gdtype", GAMMA_DTYPES)
@pytest.mark.parametrize("case", ["masked_f32", "masked_4095",
                                  "unaligned_view", "unaligned_gamma"])
def test_rmsnorm_masked_body_matches_plain(case, gdtype, lib, dev):
    """The masked body: forced at (7, 1000) float32 (a D the vector body
    takes too), picked for D = 4095 and for operands at an odd offset (a
    row view starting 2 bytes past a 16-byte boundary; a gamma view)."""
    rows, d, dtype, body, view = {
        "masked_f32": (7, 1000, torch.float32, "masked", None),
        "masked_4095": (3, 4095, torch.bfloat16, None, None),
        "unaligned_view": (5, 4096, torch.bfloat16, None, "x"),
        "unaligned_gamma": (4, 2048, torch.bfloat16, None, "gamma"),
    }[case]
    _check_rmsnorm(rows, d, dtype, lib, dev, gdtype, body=body, view=view)


def _rms_inputs(rows, d, dtype, dev, gdtype=torch.float32, view=None,
                seed=None):
    """x (rows of random scale; the first min(2, rows - 1) rows of +-0.5,
    1, 2, whose mean(x^2) is exact in any order) and gamma in [0.5, 1.5);
    ``view`` puts x or gamma at a 2-byte offset from a 16-byte boundary."""
    g = torch.Generator(device=dev).manual_seed(rows if seed is None
                                                else seed)
    x = (torch.randn(rows, d, device=dev, generator=g) *
         torch.rand(rows, 1, device=dev, generator=g) * 10)
    n_exact = min(2, rows - 1)
    x[:n_exact] = torch.tensor([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0],
                               device=dev)[torch.randint(
                                   0, 6, (n_exact, d), device=dev,
                                   generator=g)]
    gamma = (torch.rand(d, device=dev, generator=g) + 0.5).to(gdtype)
    x = x.to(dtype)
    if view == "x":
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        flat[1:].copy_(x.reshape(-1))
        x = flat[1:].view(rows, d)
        assert x.is_contiguous() and x.data_ptr() % 16
    elif view == "gamma":
        flat = torch.empty(d + 1, dtype=gdtype, device=dev)
        flat[1:].copy_(gamma)
        gamma = flat[1:]
        assert gamma.data_ptr() % 16
    return x, gamma, n_exact


def _rms_tol(design_or_meta, dtype):
    """2 rsqrt-table ulps (the sum's order may move the code by one) plus
    one output rounding in bf16."""
    tol = 2 * 2.0 ** -(design_or_meta.out_bits - 1)
    return tol + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0)


def _check_rmsnorm(rows, d, dtype, lib, dev, gdtype=torch.float32, body=None,
                   view=None):
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_lib_cuda

    x, gamma, n_exact = _rms_inputs(rows, d, dtype, dev, gdtype, view)
    n0 = dict(build.LAUNCHES)
    if body is None:
        got = approx_rmsnorm_library(x, gamma, lib)
    else:
        got = rmsnorm_lib_cuda(x, gamma, lib, body=body)
    want = approx_rmsnorm_library_ref(x, gamma, lib)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm_lib"] == n0["rmsnorm_lib"] + 1
    assert sum(build.LAUNCHES.values()) == sum(n0.values()) + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got[:n_exact], want[:n_exact])
    got, want = got.float(), want.float()
    tol = _rms_tol(lib.meta("rsqrt"), dtype)
    assert torch.all((got - want).abs() <= tol * want.abs() + 1e-30)


def test_rmsnorm_bodies_and_thread_counts_agree(lib, dev):
    """At Yi-6B's decode shape the vector body at every thread count the
    wrapper takes and the masked body forced, each also with too few
    threads to hold the row in one pass, agree with the plain version at
    the tolerance and with each other on the exact-ms rows; a gamma in
    bf16 and its float32 cast give the same bits."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_lib_cuda

    x, gamma, n_exact = _rms_inputs(4, 4096, torch.bfloat16, dev,
                                    torch.bfloat16)
    want = approx_rmsnorm_library_ref(x, gamma, lib).float()
    tol = _rms_tol(lib.meta("rsqrt"), torch.bfloat16)
    outs = [rmsnorm_lib_cuda(x, gamma, lib, tpr=tpr)
            for tpr in (64, 128, 256, 512, 1024)]
    outs.append(rmsnorm_lib_cuda(x, gamma, lib, body="masked"))
    # rows longer than one pass of the registers: read again to be written
    outs.append(rmsnorm_lib_cuda(x, gamma, lib, tpr=32))  # 2 passes
    outs.append(rmsnorm_lib_cuda(x, gamma, lib, body="masked", tpr=64))  # 8
    for out in outs:
        assert torch.equal(out[:n_exact], outs[0][:n_exact])
        assert torch.all((out.float() - want).abs() <= tol * want.abs())
    assert torch.equal(rmsnorm_lib_cuda(x, gamma.float(), lib),
                       rmsnorm_lib_cuda(x, gamma, lib))
    with pytest.raises(ValueError, match="vector body"):
        rmsnorm_lib_cuda(x[:, :4095], gamma[:4095], lib, body="vector")


def _graph_nodes(fn, tmp_path) -> int:
    """Device operations (kernel, copy and fill nodes) one ``fn()``
    enqueues: the nodes of a CUDA graph that captures it, from its DOT
    dump (the profiler loses events from some traces)."""
    import re
    import warnings

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        graph.debug_dump(str(tmp_path / "graph.dot"))
    dot = (tmp_path / "graph.dot").read_text()
    return len(re.findall(r'^"graph_\d+_node_\d+"\s*\[', dot, re.M))


def test_apply_norm_is_one_launch_and_one_device_op(lib, dev, tmp_path):
    """The served norm at Yi-6B width: ``apply_norm`` with the bf16 scale
    as stored under the fused numerics is one rmsnorm_lib launch and one
    device op (no cast of the scale, no copy of x; the scale cast first
    is two), and equals the kernel handed the scale's float32 cast."""
    from repro_torch.models.layers import apply_norm

    cfg = get_config("yi_6b")
    g = torch.Generator(device=dev).manual_seed(9)
    p = {"scale": (torch.rand(cfg.d_model, device=dev, generator=g) + 0.5
                   ).to(torch.bfloat16)}
    x = torch.randn(4, 1, cfg.d_model, device=dev, generator=g
                    ).to(torch.bfloat16)
    num = FusedInterpNumerics(lib)
    n0 = dict(build.LAUNCHES)
    got = apply_norm(p, x, cfg, num)
    assert build.LAUNCHES["rmsnorm_lib"] == n0["rmsnorm_lib"] + 1
    assert sum(build.LAUNCHES.values()) == sum(n0.values()) + 1
    assert torch.equal(got, num.rmsnorm(x, p["scale"].float()))
    assert _graph_nodes(lambda: apply_norm(p, x, cfg, num), tmp_path) == 1
    assert _graph_nodes(lambda: num.rmsnorm(x, p["scale"].float()),
                        tmp_path) == 2


# softmax shapes: the DeepSeekMoE router at decode and prefill (D = 64,
# float32), wide bf16 rows, the per-table phase's (16384, 512) scores, a
# row read in two passes, and ragged D for the masked body; (rows, d,
# dtype, view): view puts x at a 2-byte offset from a 16-byte boundary
SOFTMAX_SHAPES = [(4, 64, torch.float32, False),
                  (511, 64, torch.float32, False),
                  (8, 4096, torch.bfloat16, False),
                  (7, 1000, torch.float32, False),
                  (3, 1500, torch.bfloat16, False),
                  (5, 33, torch.bfloat16, False),
                  (16384, 512, torch.float32, False),
                  (1, 8192, torch.bfloat16, False),
                  (2, 32768, torch.float32, False),
                  (3, 4095, torch.bfloat16, False),
                  (5, 4096, torch.bfloat16, True)]


@pytest.mark.parametrize("rows,d,dtype,view", SOFTMAX_SHAPES)
def test_softmax_kernel_matches_plain(rows, d, dtype, view, lib, dev):
    """The DeepSeekMoE router at decode and prefill (D = 64, float32), wide
    bf16 rows, (16384, 512) scores, a row longer than one pass, ragged
    rows on the masked body and a row view at an odd offset; rows 0-1 hold
    equal values and a spread past the t = 126 clamp."""
    _check_softmax(rows, d, dtype, lib, dev, view)


def _softmax_inputs(rows, d, dtype, dev, view=False, seed=None):
    g = torch.Generator(device=dev).manual_seed(rows + d if seed is None
                                                else seed)
    x = torch.randn(rows, d, device=dev, generator=g) * 4
    x[0] = 1.5
    if rows > 1:
        x[1, ::2] = -1000.0
    x = x.to(dtype)
    if view:
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        flat[1:].copy_(x.reshape(-1))
        x = flat[1:].view(rows, d)
        assert x.is_contiguous() and x.data_ptr() % 16
    return x


def _twin_shape(x, **kw):
    """(vec, tpr) of the wrapper's launch for x (``body``, ``tpr`` as the
    wrapper takes them)."""
    vector = vector_ok(x, torch.empty_like(x)) and kw.get("body") != "masked"
    _, tpr, _, _ = launch_shape(x.shape[0], x.shape[1], x.element_size(),
                                vector, kw.get("tpr"))
    return (16 // x.element_size() if vector else 1), tpr


def _check_softmax(rows, d, dtype, lib, dev, view=False):
    x = _softmax_inputs(rows, d, dtype, dev, view)
    em, rm = lib_meta(lib, "exp2neg"), lib_meta(lib, "recip")
    n0 = build.LAUNCHES["softmax_lib"]
    got, e = softmax_lib_cuda(x, lib, return_e=True)
    assert torch.equal(approx_softmax_library(x, lib), got)
    want = approx_softmax_library_ref(x, lib)
    _, e_ref = softmax_exp(x, lib.coeffs, em)
    twin = kernel_order_softmax(x, lib.coeffs, lib.coeffs, em, rm,
                                *_twin_shape(x))
    torch.cuda.synchronize()
    assert build.LAUNCHES["softmax_lib"] == n0 + 2
    assert got.dtype == dtype and torch.equal(e, e_ref)
    assert torch.equal(got, twin)
    tol = 2.0 ** -(lib.meta("recip").in_bits - 1)
    if dtype == torch.bfloat16:
        tol += 2.0 ** -7
    got, want = got.float(), want.float()
    assert torch.all((got - want).abs() <= tol * want.abs() + 1e-30)
    assert torch.allclose(got[0], torch.full_like(got[0], got[0, 0]))


def test_softmax_bodies_and_thread_counts_agree(lib, dev):
    """At the router's, a wide bf16, a ragged and a many-row shape, the
    vector body at every thread count per row the wrapper takes (sub-warp
    rows, whole warps, multi-warp rows, rows read in passes) and the masked
    body forced at each, each with and without the float table of exp2neg
    outputs: e bitwise, and the output bitwise the twin with the kernels'
    sum order at that launch (the order is fixed per thread count), so
    equal wherever two orders give one reciprocal code."""
    em, rm = lib_meta(lib, "exp2neg"), lib_meta(lib, "recip")
    tprs = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
    n = 0
    for rows, d, dtype in ((4, 64, torch.float32), (8, 4096, torch.bfloat16),
                           (37, 1000, torch.bfloat16), (3, 200, torch.float32),
                           (2048, 512, torch.float32)):
        x = _softmax_inputs(rows, d, dtype, dev)
        _, e_ref = softmax_exp(x, lib.coeffs, em)
        for body in ("vector", "masked"):
            for tpr in tprs:
                try:
                    vec, t = _twin_shape(x, body=body, tpr=tpr)
                except ValueError:  # 1024 threads of 32 elements
                    continue
                if rows * t * d // vec > 1 << 22 or (d // vec) // t > 512:
                    continue  # keep the twin's loops short
                twin = kernel_order_softmax(x, lib.coeffs, lib.coeffs, em,
                                            rm, vec, t)
                for lut in (False, True) if t <= 512 else (False,):
                    got, e = softmax_lib_cuda(x, lib, return_e=True,
                                              body=body, tpr=tpr, lut=lut)
                    assert torch.equal(e, e_ref), (rows, d, body, tpr, lut)
                    assert torch.equal(got, twin), (rows, d, body, tpr, lut)
                    n += 1
    assert n >= 150


def test_softmax_kernel_captures_in_a_cuda_graph(lib, dev):
    """The wrapper does not sync with the host: a CUDA graph captures the
    router's call and a many-block one, and its replay equals the eager
    calls bitwise."""
    xs = [_softmax_inputs(4, 64, torch.float32, dev),
          _softmax_inputs(16384, 512, torch.float32, dev)]
    want = [approx_softmax_library(x, lib) for x in xs]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [approx_softmax_library(x, lib) for x in xs]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_router_softmax_is_one_launch_and_one_device_op(lib, dev, tmp_path):
    """The served router softmax, ``FusedInterpNumerics.softmax`` on
    DeepSeekMoE's decode logits (1, 4, 64) float32: one softmax_lib launch
    and one device op (no copy, no cast), equal to the kernel's call."""
    x = _softmax_inputs(4, 64, torch.float32, dev).reshape(1, 4, 64)
    num = FusedInterpNumerics(lib)
    n0 = dict(build.LAUNCHES)
    got = num.softmax(x, axis=-1)
    torch.cuda.synchronize()
    assert build.LAUNCHES["softmax_lib"] == n0["softmax_lib"] + 1
    assert sum(build.LAUNCHES.values()) == sum(n0.values()) + 1
    assert torch.equal(got, softmax_lib_cuda(x.reshape(4, 64), lib
                                             ).reshape(1, 4, 64))
    assert _graph_nodes(lambda: num.softmax(x, axis=-1), tmp_path) == 1


# decode: 4 slots against the cache, (Sk, cache lengths, window); the
# lengths of "decode_dead" and its window leave whole key splits dead
DECODE = {"decode": (1024, (17, 300, 1000, 600), None),
          "decode_g1": (1024, (17, 300, 1000, 600), None),
          "decode_4096": (4096, (100, 1500, 4096, 3001), None),
          "decode_dead": (1024, (1, 65, 200, 1024), 128)}


# Mixtral's ring at decode: the window each case masks with
RING = {"ring": 4096, "ring_w3000": 3000}

# Whisper's non-causal attention: (B, Sq, Sk) of the encoder over its frames
# (positions arange) and of cross attention (every position 0); 100 keys is
# a ragged last tile (64 + 36), 1500 = 23 x 64 + 28 the served source length
NONCAUSAL = {"encoder": (2, 100, 100), "cross": (2, 4, 100),
             "cross_decode": (4, 1, 1500), "cross_prefill": (4, 4, 1500)}


def _flash_case(mode, dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    kw = dict(device=dev, dtype=dtype)
    if mode in NONCAUSAL:  # Whisper: 6 heads over 6, D 64
        b, sq, sk = NONCAUSAL[mode]
        h = kvh = 6
        k = torch.randn(b, sk, kvh, 64, generator=g, **kw)
        v = torch.randn(b, sk, kvh, 64, generator=g, **kw)
        q = torch.randn(b, sq, h, 64, generator=g, **kw)
        if mode == "encoder":
            kv_pos = torch.arange(sk, device=dev).expand(b, sk)
            q_pos = kv_pos
        else:
            kv_pos = torch.zeros((b, sk), dtype=torch.int32, device=dev)
            q_pos = torch.zeros((b, sq), dtype=torch.int32, device=dev)
        return q, k, v, q_pos.to(torch.int32), kv_pos.to(torch.int32), None
    if mode in DECODE:  # 4 slots against a cache view, dead rows
        # Yi-6B: 32 query heads over 4 KV heads; DeepSeekMoE: 16 over 16
        sk, lens, window = DECODE[mode]
        b, sq, h, kvh, d = 4, 1, 32, 4, 128
        if mode == "decode_g1":
            h = kvh = 16
        kc = torch.randn(b, kvh, sk, d, generator=g, **kw)
        vc = torch.randn(b, kvh, sk, d, generator=g, **kw)
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)  # cache views
        lens = torch.tensor(lens, device=dev)
        kv_pos = torch.arange(sk, device=dev).expand(b, sk).clone()
        kv_pos[kv_pos >= lens[:, None]] = -1
        q_pos = (lens - 1)[:, None]
    elif mode in ("prefill", "prefill_g1"):  # causal prefill, Sq = Sk = 512
        b, sq, sk, h, kvh, d = 1, 512, 512, 32, 4, 128
        if mode == "prefill_g1":
            h = kvh = 16
        k = torch.randn(b, sk, kvh, d, generator=g, **kw)
        v = torch.randn(b, sk, kvh, d, generator=g, **kw)
        kv_pos = torch.arange(sk, device=dev).expand(b, sk)
        q_pos = kv_pos
        window = None
    elif mode == "wide_head":  # D = 256: bf16 past the tensor-core body
        b, sq, sk, h, kvh, d = 1, 5, 70, 2, 1, 256
        k = torch.randn(b, sk, kvh, d, generator=g, **kw)
        v = torch.randn(b, sk, kvh, d, generator=g, **kw)
        kv_pos = torch.arange(sk, device=dev).expand(b, sk)
        q_pos = torch.arange(sk - sq, sk, device=dev).expand(b, sq)
        window = None
    elif mode in ("mla_decode", "mla_prefill"):
        # MiniCPM3-4B's MLA: 40 heads over 40 (g = 1), Dk 96 (nope 64 +
        # rope 32) against Dv 64; V the strided second half of the latent
        # expansion (B, S, H, 64 + 64), as the model hands it
        h = kvh = 40
        b, sq, sk = (4, 1, 1024) if mode == "mla_decode" else (1, 511, 511)
        k = torch.randn(b, sk, h, 96, generator=g, **kw)
        v = torch.randn(b, sk, h, 128, generator=g, **kw)[..., 64:]
        kv_pos = torch.arange(sk, device=dev).expand(b, sk).clone()
        if mode == "mla_decode":
            lens = torch.tensor((17, 300, 1000, 600), device=dev)
            kv_pos[kv_pos >= lens[:, None]] = -1
            q_pos = (lens - 1)[:, None]
        else:
            q_pos = kv_pos
        q = torch.randn(b, sq, h, 96, generator=g, **kw)
        return q, k, v, q_pos.to(torch.int32), kv_pos.to(torch.int32), None
    elif mode in RING:
        # Mixtral's 4096-row window ring at decode: 4 slots of 48 query
        # heads over 8, row r holding the position p with p % 4096 == r;
        # the slots' latest positions rotate the ring by 0, 1, 4095 and
        # 105 rows (row 0 is not the oldest)
        window = RING[mode]
        b, sq, sk, h, kvh, d = 4, 1, 4096, 48, 8, 128
        kc = torch.randn(b, kvh, sk, d, generator=g, **kw)
        vc = torch.randn(b, kvh, sk, d, generator=g, **kw)
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        last = torch.tensor((8191, 8192, 12286, 4200), device=dev)
        r = torch.arange(sk, device=dev)
        kv_pos = last[:, None] - torch.remainder(last[:, None] - r, sk)
        q_pos = last[:, None]
    elif mode == "qwen_decode":  # Qwen1.5-110B: 64 query heads over 8
        b, sq, sk, h, kvh, d = 4, 1, 1024, 64, 8, 128
        kc = torch.randn(b, kvh, sk, d, generator=g, **kw)
        vc = torch.randn(b, kvh, sk, d, generator=g, **kw)
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        lens = torch.tensor((17, 300, 1000, 600), device=dev)
        kv_pos = torch.arange(sk, device=dev).expand(b, sk).clone()
        kv_pos[kv_pos >= lens[:, None]] = -1
        q_pos = (lens - 1)[:, None]
        window = None
    else:  # small GQA with a window, padded query rows, ragged last tile
        b, sq, sk, h, kvh, d = 2, 37, 100, 6, 2, 16
        k = torch.randn(b, sk, kvh, d, generator=g, **kw)
        v = torch.randn(b, sk, kvh, d, generator=g, **kw)
        kv_pos = torch.arange(sk, device=dev).expand(b, sk).clone()
        kv_pos[1, 80:] = -1
        q_pos = torch.arange(63, 100, device=dev).expand(b, sq).clone()
        q_pos[1, 30:] = -1
        window = 50
    q = torch.randn(b, sq, h, d, generator=g, **kw)
    return q, k, v, q_pos.to(torch.int32), kv_pos.to(torch.int32), window


def _tiles(q, k, v):
    """The kernel's query tile and key splits for (B, Sq, H, D) q and
    (B, Sk, KVH, D) K/V: what the tile twin needs to skip and combine as
    the kernel does."""
    b, sq, h, _ = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    tq = query_tile(sq, h // kvh, v.shape[-1])
    return tq, kv_splits(b, kvh, -(-sq // tq), sk)


@pytest.mark.parametrize("mode,dtype", [("decode", torch.bfloat16),
                                        ("decode_g1", torch.bfloat16),
                                        ("decode_4096", torch.bfloat16),
                                        ("decode_dead", torch.bfloat16),
                                        ("decode_dead", torch.float32),
                                        ("prefill", torch.bfloat16),
                                        ("prefill_g1", torch.bfloat16),
                                        ("small", torch.float32),
                                        ("small", torch.bfloat16),
                                        ("wide_head", torch.bfloat16)])
def test_flash_kernel_matches_plain(mode, dtype, lib, dev):
    _check_flash(mode, dtype, lib, dev)


def _check_flash(mode, dtype, lib, dev):
    q, k, v, q_pos, kv_pos, window = _flash_case(mode, dev, dtype)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=window,
              causal=mode not in NONCAUSAL)
    n0 = build.LAUNCHES["flash_attn_lib"]
    got = attention_fused_library(q, k, v, lib, **kw).float()
    want = attention_fused_library_ref(q, k, v, lib, **kw).float()
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attn_lib"] == n0 + 1
    live = q_pos >= 0
    got, want = got[live], want[live]
    bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    vmax = v.float().abs().max()
    tol = ((k.shape[1] + 63) // 64 + 2) * bound * vmax
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * (vmax + want.abs())
    err = (got - want).abs()
    assert torch.all(err <= tol), float(err.max())
    tq, splits = _tiles(q, k, v)
    if mode in DECODE:
        assert splits > 1
    twin = attention_fused_library_ref(q, k, v, lib, block_k=64, block_q=tq,
                                       kv_splits=splits, **kw).float()[live]
    tight = bound * vmax
    if dtype == torch.bfloat16:
        tight = tight + 2.0 ** -8 * twin.abs()
    err = (got - twin).abs()
    assert torch.all(err <= tight), float(err.max())


def _smoke(dev, arch, dtype="float32"):
    cfg = get_smoke_config(arch).replace(numerics="interp-fused",
                                         param_dtype=dtype)
    return cfg, tf.init_params(cfg, seed=0, device=dev)


def _per_forward(cfg, mode: str = "decode") -> dict:
    """Kernel launches of one forward pass (a "prefill" or a "decode"): an
    rmsnorm before the mixer of every layer, before the FFN of every layer
    that has one, the final one, MLA's q_norm and kv_norm and the SSM
    mixer's gated norm; one attention per attention layer; one activation
    (``act_lib``: the glue and the table read in one kernel) per SwiGLU or
    GELU MLP (squared ReLU reads no table), per expert group (routed,
    shared) and three per SSM layer (conv output, dt's softplus, the
    gate); one router softmax per MoE layer; the SSM recurrence's exp_neg
    table reads (``library_eval``), four per SSM layer in a prefill and
    one in a decode. An encoder-decoder adds one cross attention per
    layer, and its LayerNorms read no table; ``mode="encoder"`` counts
    ``encoder_forward``: one attention and one activation per encoder
    layer."""
    if mode == "encoder":
        n = cfg.encoder.n_layers
        return {**dict.fromkeys(build.LAUNCHES, 0), "flash_attn_lib": n,
                "act_lib": n}
    kinds = [slot[-1] for slot in tf.layer_slots(cfg)]
    n_moe = sum(k.ffn == "moe" for k in kinds)
    n_mlp = 0 if cfg.act == "relu2" else sum(k.ffn == "mlp" for k in kinds)
    n_ssm = sum(k.mixer == "ssm" for k in kinds)
    n_ffn = sum(k.ffn is not None for k in kinds)
    shared = int(bool(cfg.moe and cfg.moe.n_shared))
    mla = 2 * (cfg.n_layers - n_ssm) if cfg.mla is not None else 0
    norms = (0 if cfg.norm == "layernorm"
             else cfg.n_layers + n_ffn + mla + n_ssm + 1)
    cross = cfg.n_layers if cfg.encoder is not None else 0
    return {**dict.fromkeys(build.LAUNCHES, 0),
            "act_lib": n_mlp + n_moe * (1 + shared) + 3 * n_ssm,
            "rmsnorm_lib": norms,
            "flash_attn_lib": cfg.n_layers - n_ssm + cross,
            "softmax_lib": n_moe,
            "library_eval": (4 if mode == "prefill" else 1) * n_ssm}


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_smoke_prefill_through_kernels_matches_plain(arch, lib, dev):
    cfg, params = _smoke(dev, arch)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    build.reset_launches()
    got, _ = tf.prefill(params, toks, cfg, FusedInterpNumerics(lib), 64)
    assert build.LAUNCHES == _per_forward(cfg)
    want, _ = tf.prefill(params, toks, cfg, PlainFusedNumerics(lib), 64)
    tol = 4 * 2.0 ** -12 * want.abs().max()
    assert torch.all((got - want).abs() <= tol)


def test_router_kernel_routes_as_plain(lib, dev):
    """DeepSeekMoE's router at full width (d = 2048, 64 experts, top-6) on
    511 prompt tokens: the kernel's probabilities give the plain version's
    expert ids, and gates within one recip step."""
    cfg = get_config("deepseek_moe_16b")
    g = torch.Generator(device=dev).manual_seed(2)
    p = {"router": torch.randn(cfg.d_model, cfg.moe.n_experts, device=dev,
                               generator=g) / cfg.d_model ** 0.5}
    x = torch.randn(1, 511, cfg.d_model, device=dev, generator=g
                    ).to(torch.bfloat16)
    _, idx, gate = moe.route(p, x, cfg, FusedInterpNumerics(lib))
    _, idx_p, gate_p = moe.route(p, x, cfg, PlainFusedNumerics(lib))
    assert torch.equal(idx, idx_p)
    assert torch.allclose(gate, gate_p, rtol=2.0 ** -10, atol=0)


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_engine_on_card_counts_and_batching(arch, lib, dev):
    cfg, params = _smoke(dev, arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 3)]

    def serve(ps, rids):
        eng = ServeEngine(cfg, params, slots=2, cache_len=32, library=lib,
                          horizon=4, device=dev)
        for i, p in zip(rids, ps):
            eng.submit(Request(i, p, max_new=5))
        return eng, {r.rid: r.out for r in eng.run()}

    eng, out = serve(prompts, range(3))
    forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
    assert eng.stats["launches"] == {
        k: n * forwards for k, n in _per_forward(cfg).items()}
    for i, p in enumerate(prompts):
        assert serve([p], [i])[1][i] == out[i]


# ---------------------------------------------------------------- generator

def _bounds_f32(dev, shape, seed, steep=False):
    """Integer bounds: random monotone rows, or the steep table's
    -2^24 * x rows (U = L + 0..8), where float32 rounds the numerators."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    if steep:
        L = np.broadcast_to(-(1 << 24) * np.arange(n, dtype=np.int64),
                            shape).copy()
    else:
        L = np.cumsum(rng.integers(0, 3, shape), axis=-1)
    U = L + rng.integers(0, 9 if steep else 4, shape)
    return (torch.as_tensor(L, dtype=torch.float32, device=dev),
            torch.as_tensor(U, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("shape,steep", [
    ((32, 2048), False), ((256, 256), False), ((3, 200), False),
    ((5, 3), False), ((2, 9000), False), ((1, 24000), False),
    ((1, 2048), False), ((7, 1001), False), ((3, 32, 2048), False),
    ((1, 16), True), ((4, 2048), True), ((1, 1 << 16), False),
    ((2, (1 << 16) + 1), False)])
def test_envelope_kernels_bitwise(shape, steep, dev):
    """The three envelope entry points against the plain stencil, bitwise:
    the generator's widths (one row: offset groups in a cluster), a width
    off the 32-center tile, the narrowest row the kernel takes, rows whose
    offsets take 5 and 8 groups (clusters), the Table I trio's fleet stack,
    the steep rows, the widest staged row (2^16) and rows one wider, read
    through the read-only cache; the launch counters move by one each."""
    L, U = _bounds_f32(dev, shape, sum(shape), steep)
    n = shape[-1]
    rows = L.numel() // n
    want = dref.envelopes_parity_ref(L.reshape(rows, n), U.reshape(rows, n))
    n0 = dict(build.LAUNCHES)
    got_b = dk.envelopes_parity_batched_cuda(L.reshape(rows, n),
                                             U.reshape(rows, n))
    fleet = L.reshape(-1, shape[-2] if len(shape) > 1 else 1, n)
    got_f = dk.envelopes_parity_fleet_cuda(fleet, U.reshape(fleet.shape))
    got_1 = dk.envelopes_parity_cuda(L.reshape(rows, n)[-1],
                                     U.reshape(rows, n)[-1])
    torch.cuda.synchronize()
    for gb, gf, g1, w in zip(got_b, got_f, got_1, want):
        assert torch.equal(gb, w) and torch.equal(gf.reshape(rows, n), w)
        assert torch.equal(g1, w[-1])
    for name in ("envelopes_parity", "envelopes_parity_batched",
                 "envelopes_parity_fleet"):
        assert build.LAUNCHES[name] == n0[name] + 1


def _quotient_cases(kind):
    """(num, d) float32 pairs the envelope quotient's proof turns on:
    N / d within u / d of a rounding midpoint (u = 2^-24 at [1, 2); eps = +-1
    is as close as any N / d comes), candidates one float32 ulp apart, and
    equal quotients of different divisors."""
    rng = np.random.default_rng(len(kind))
    if kind == "midpoint":  # N * 2^24 = eps (mod d): N = d + (eps 2^-24 mod d)
        d = rng.integers(3, (1 << 22) - 1, 4000) | 1
        eps = rng.choice([-3, -2, -1, 1, 2, 3], 4000)
        num = np.array([int(di) + (int(ei) * pow(1 << 24, -1, int(di)))
                        % int(di) for di, ei in zip(d, eps)], np.float64)
        num *= 2.0 ** rng.integers(0, 20, 4000)
    elif kind == "one_ulp":  # N2 / d2 one ulp above RN(N1 / d1)
        d1 = rng.integers(1, 1 << 12, 2000)
        n1 = rng.integers(-(1 << 24), 1 << 24, 2000).astype(np.float32)
        q2 = np.nextafter((n1 / d1.astype(np.float32)).astype(np.float32),
                          np.float32(np.inf), dtype=np.float32)
        d2 = rng.integers(1, 1 << 12, 2000)
        n2 = (q2.astype(np.float64) * d2).astype(np.float32)
        num, d = np.concatenate([n1, n2]), np.concatenate([d1, d2])
    else:  # "equal": N k / (d k)
        d1 = rng.integers(1, 1 << 12, 2000)
        n1 = rng.integers(-(1 << 24), 1 << 24, 2000).astype(np.float32)
        k = rng.integers(2, 64, 2000)
        num = np.concatenate([n1, (n1.astype(np.float64) * k)])
        d = np.concatenate([d1, d1 * k])
    return (torch.as_tensor(num, dtype=torch.float32),
            torch.as_tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("kind", ["midpoint", "one_ulp", "equal"])
def test_envelope_quotient_kernel_is_ieee_quotient(kind, dev):
    """The compiled divide-free quotient of the envelope kernel (the same
    div_by, with r = RN(1/d) as its table holds it) against the IEEE
    divide on the CPU and the plain version of the quotient, bitwise."""
    num, d = _quotient_cases(kind)
    num_c, d_c = num.to(dev), d.to(dev)
    q = torch.empty(num.numel(), device=dev)
    rc = build.load().repro_envelope_quotient(
        num_c.data_ptr(), d_c.data_ptr(), num.numel(), q.data_ptr(),
        dev.index or 0, build.stream_of(dev))
    build.check("envelope_quotient", rc)
    got = q.cpu()
    assert torch.equal(got, num / d)
    assert torch.equal(got, dref.envelope_quotient_ref(num, d))


@pytest.mark.parametrize("rows,t", [(32, 4093), (512, 125), (3, 2), (3, 3),
                                    (2, 30001)])
def test_dd_max_rows_bitwise(rows, t, dev):
    """The one-sided launch against the plain version, and the two-sided
    launch against dd_max_rows2_ref and the two one-sided calls it
    replaces, bitwise: the generator's width, many short rows, the
    narrowest rows, and a row too wide to stage (read through the
    read-only cache); one launch each, counted under dd_max_rows; a second
    launch into fresh outputs (filled anew by the C entry) agrees."""
    g = torch.Generator(device=dev).manual_seed(t)
    a = torch.randn(rows, t, device=dev, generator=g) * 1000
    b = a - torch.rand(rows, t, device=dev, generator=g) * 50
    n0 = build.LAUNCHES["dd_max_rows"]
    got = dk.dd_max_rows_cuda(a, b)
    assert torch.equal(got, dref.dd_max_rows_ref(a, b))
    assert build.LAUNCHES["dd_max_rows"] == n0 + 1
    lo, hi = dk.dd_max_rows2_cuda(a, b)
    assert build.LAUNCHES["dd_max_rows"] == n0 + 2
    want = dref.dd_max_rows2_ref(a, b)
    assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    assert torch.equal(lo, got)
    assert torch.equal(hi, -dk.dd_max_rows_cuda(-b, -a))
    again = dk.dd_max_rows2_cuda(a, b)
    assert torch.equal(again[0], lo) and torch.equal(again[1], hi)


def test_front_half_launches_once_per_call(dev):
    """region_envelopes_device and fleet_region_envelopes_device: one
    envelope launch and one two-sided dd_max_rows launch a call."""
    L, U = get_spec("recip", 12).region_bounds(5)
    for call, name, args in (
            (dops.region_envelopes_device, "envelopes_parity_batched",
             (L, U)),
            (dops.fleet_region_envelopes_device, "envelopes_parity_fleet",
             (L[None], U[None]))):
        n0 = dict(build.LAUNCHES)
        call(*args, device=dev)
        moved = {k: build.LAUNCHES[k] - n0[k] for k in build.LAUNCHES
                 if build.LAUNCHES[k] != n0[k]}
        assert moved == {name: 1, "dd_max_rows": 1}


def test_region_envelopes_device_card_equals_cpu(dev):
    """recip-16 at R = 5 and the steep regression table of the reference's
    fleet tests: the card's front half equals the CPU plain versions'."""
    L, U = get_spec("recip", 16).region_bounds(5)
    x = np.arange(16, dtype=np.int64)
    steep = (-(1 << 24) * x).reshape(1, 16)
    for Lr, Ur in ((L, U), (steep, steep + 8)):
        got = dops.region_envelopes_device(Lr, Ur, device=dev)
        want = dops.region_envelopes_device(Lr, Ur, device="cpu")
        for g_, w in zip(got, want):
            np.testing.assert_array_equal(g_, w)
        got = dops.fleet_region_envelopes_device(Lr[None], Ur[None],
                                                 device=dev)
        for g_, w in zip(got, want):
            np.testing.assert_array_equal(g_, w)


def test_interp_eval_kernel_every_table(lib, dev):
    """interp_eval on all 4096 codes of each default table, and on ragged
    shapes, against the plain version and TableDesign.eval_int."""
    from repro_torch.api.library import DEFAULT_TABLE_KEY, TABLES_DIR

    codes = torch.arange(4096, dtype=torch.int32, device=dev)
    for kind in lib.kinds:
        d = TableDesign.from_dict(json.loads(
            (TABLES_DIR / f"{kind}_{DEFAULT_TABLE_KEY}.json").read_text()))
        n0 = build.LAUNCHES["interp_eval"]
        got = table_eval(codes, d)
        assert build.LAUNCHES["interp_eval"] == n0 + 1
        np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64),
                                      d.eval_int(np.arange(4096)))
        dp = dict(eval_bits=d.eval_bits, k=d.k, sq_trunc=d.sq_trunc,
                  lin_trunc=d.lin_trunc, degree=d.degree)
        ragged = codes[:1001].reshape(7, 11, 13).flip(0)
        assert torch.equal(interp_eval_cuda(ragged, d.device_coeffs(dev), **dp),
                           interp_eval_ref(ragged, d.device_coeffs(dev), **dp))


def test_table_eval_wide_design_on_card(dev):
    """A design whose coefficients exceed int32 takes the int64 path on the
    card and equals eval_int (low 32 bits)."""
    rng = np.random.default_rng(3)
    r = 4
    meta = CoeffMeta(40, 0, True)
    d = TableDesign("wide", 12, 20, r, 30, 2, 1, 0,
                    rng.integers(-2**20, 2**20, 1 << r),
                    rng.integers(-2**36, 2**36, 1 << r),
                    rng.integers(2**45, 2**46, 1 << r), meta, meta, meta)
    assert not d.fits_int32
    codes = torch.arange(4096, dtype=torch.int32, device=dev)
    n0 = build.LAUNCHES["interp_eval"]
    got = table_eval(codes, d).cpu().numpy()
    assert build.LAUNCHES["interp_eval"] == n0
    want = d.eval_int(np.arange(4096)).astype(np.int64)
    np.testing.assert_array_equal(got, ((want + 2**31) % 2**32 - 2**31))


def test_pallas_engine_on_card_matches_exact(dev):
    """recip-12 under engine="pallas" on the card: the exact engine's
    minimum R and design; compile() on the card under both device paths
    gives the vendored library's checksum."""
    spec = get_spec("recip", 12)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        exact = Explorer(ExploreConfig(cache_dir=d1)).explore(spec)
        n0 = dict(build.LAUNCHES)
        card = Explorer(ExploreConfig(engine="pallas", device="cuda",
                                      cache_dir=d2)).explore(spec)
        assert build.LAUNCHES["envelopes_parity_batched"] > \
            n0["envelopes_parity_batched"]
    assert card.min_regions_r == exact.min_regions_r
    assert card.best.design.to_dict() == exact.best.design.to_dict()
    for kw in ({"engine": "pallas"}, {"mesh": 2}):
        with tempfile.TemporaryDirectory() as d:
            lib = Explorer(ExploreConfig(cache_dir=d, device="cuda",
                                         **kw)).compile()
        assert lib.rom_sha() == "12aa483ae8456c2f" and lib.coeffs.is_cuda


# The card counterparts of tests/test_torch_explorer.py's device cases.

@pytest.mark.parametrize("engine", ["pooled", "batched", "pallas"])
def test_explorer_engines_identical_designs_on_card(engine, dev):
    """recip-8 at R = 3: every engine on the card, ``pallas`` through the
    envelope kernel, gives the batched engine's design."""
    spec = get_spec("recip", 8)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        want = Explorer(ExploreConfig(cache_dir=d1)).explore_r(spec, 3)
        n0 = build.LAUNCHES["envelopes_parity_batched"]
        got = Explorer(ExploreConfig(engine=engine, device="cuda",
                                     cache_dir=d2)).explore_r(spec, 3)
        assert (build.LAUNCHES["envelopes_parity_batched"] > n0) == (
            engine == "pallas")
    assert got.design.to_dict() == want.design.to_dict()


def test_fleet_compile_on_card_bitwise_serial(dev):
    """The default manifest through the fleet's device front half
    (``mesh=2``, the fleet kernel) equals the serial per-kind path:
    metadata, ROM and table files."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        n0 = build.LAUNCHES["envelopes_parity_fleet"]
        fleet = Explorer(ExploreConfig(cache_dir=d1, device="cuda",
                                       mesh=2)).compile()
        assert build.LAUNCHES["envelopes_parity_fleet"] > n0
        serial = Explorer(ExploreConfig(cache_dir=d2, device="cuda",
                                        fleet=False)).compile()
        files = [{p.name: p.read_bytes() for p in
                  pathlib.Path(d).glob("*.json")}
                 for d in (d1, d2)]
    assert fleet.metas == serial.metas
    assert torch.equal(fleet.coeffs, serial.coeffs) and fleet.coeffs.is_cuda
    assert fleet.rom_sha() == "12aa483ae8456c2f"
    assert files[0] == files[1] and files[0]


def test_fleet_warm_cache_short_circuits_on_card(dev):
    """A second device-fleet compile loads every table from the cache: no
    envelope launch, no disk write, the same ROM."""
    with tempfile.TemporaryDirectory() as d:
        ex = Explorer(ExploreConfig(cache_dir=d, device="cuda", mesh=2))
        lib1 = ex.compile(["recip", "exp2neg"])
        stamp = {p.name: p.stat().st_mtime_ns
                 for p in pathlib.Path(d).glob("*.json")}
        n0 = dict(build.LAUNCHES)
        lib2 = ex.compile(["recip", "exp2neg"])
        assert dict(build.LAUNCHES) == n0
        assert {p.name: p.stat().st_mtime_ns for p in
                pathlib.Path(d).glob("*.json")} == stamp
    assert torch.equal(lib1.coeffs, lib2.coeffs)


def test_mesh_device_spaces_never_poison_exact_cache_on_card(dev):
    """``mesh=2`` on the card: the fleet kernel's float32 spaces stay out
    of the exact engine's cache and agree with its verdicts."""
    spec = get_spec("recip", 8)
    with tempfile.TemporaryDirectory() as d:
        ex = Explorer(ExploreConfig(cache_dir=d, device="cuda", mesh=2))
        n0 = build.LAUNCHES["envelopes_parity_fleet"]
        spaces = ex._envelopes_fleet([(spec, 3)])
        assert build.LAUNCHES["envelopes_parity_fleet"] > n0
        assert len(spaces[0]) == 8
        assert ex.envelope_stats["computed"] == 0 and not ex._spaces
        exact = Explorer(ExploreConfig(cache_dir=d)).envelopes(spec, 3)
        assert [s.feasible for s in spaces[0]] == [s.feasible for s in exact]
        assert ex.feasible(spec, 3) == ex.feasible(spec, 3)


# ------------------------------------------------------- segmented (ROM v2)

@pytest.fixture(scope="module")
def _seg_cpu():
    """The default manifest through compile_segmented on the CPU (every
    slot segmented, f775a828748d4ea9)."""
    with tempfile.TemporaryDirectory() as d:
        lib = Explorer(ExploreConfig(device="cpu", cache_dir=d)
                       ).compile_segmented()
    assert lib.rom_sha() == "f775a828748d4ea9"
    return lib


@pytest.fixture
def seg_lib(dev, _seg_cpu):
    return InterpLibrary(_seg_cpu.coeffs.to(dev), _seg_cpu.metas).seal()


def test_walk_and_rom_eval_every_code_both_libraries(lib, seg_lib, _seg_cpu,
                                                     dev):
    """library_walk (one id, and per-element ids) and rom_eval on all 4096
    codes of every slot of the uniform and the segmented library equal the
    walk's plain version and eval_int's CPU plain version."""
    cpu_libs = (InterpLibrary.default_library("cpu"), _seg_cpu)
    codes = torch.arange(4096, dtype=torch.int32, device=dev)
    for card, host in zip((lib, seg_lib), cpu_libs):
        walk, dp = card.walk_rows()
        for kind in card.kinds:
            fid = card.func_id(kind)
            want = host.eval_int(codes.cpu(), kind)
            n0 = dict(build.LAUNCHES)
            one = library_walk(codes, fid, card.coeffs, walk, dp)
            each = library_walk(codes, torch.full_like(codes, fid),
                                card.coeffs, walk, dp)
            rom = rom_eval(codes, card, kind)
            torch.cuda.synchronize()
            assert build.LAUNCHES["library_walk"] == n0["library_walk"] + 2
            assert build.LAUNCHES["rom_eval"] == n0["rom_eval"] + 1
            plain = library_walk_ref(codes, torch.full_like(codes, fid),
                                     card.coeffs, walk, dp)
            for got in (one, each, rom, plain):
                assert torch.equal(got.cpu(), want), kind
        if card is seg_lib:
            assert torch.equal(card.eval_int(codes, "tanh").cpu(),
                               host.eval_int(codes.cpu(), "tanh"))


@pytest.mark.parametrize("shape", [(4, 1, 11008), (1, 512, 11008)])
def test_library_walk_mixed_ids_at_silu_shapes(shape, lib, seg_lib, dev):
    """Random codes and per-element ids at Yi-6B's silu shapes: the walk
    equals its plain version on both libraries, and library_eval on the
    uniform one."""
    g = torch.Generator(device=dev).manual_seed(3)
    codes = torch.randint(0, 4096, shape, dtype=torch.int32, device=dev,
                          generator=g)
    fids = torch.randint(0, len(lib), shape, dtype=torch.int32, device=dev,
                         generator=g)
    for card in (lib, seg_lib):
        walk, dp = card.walk_rows()
        got = library_walk(codes, fids, card.coeffs, walk, dp)
        assert torch.equal(got, library_walk_ref(codes, fids, card.coeffs,
                                                 walk, dp))
    assert torch.equal(library_walk(codes, fids, lib.coeffs,
                                    *lib.walk_rows()),
                       library_eval(codes, fids, lib.coeffs,
                                    lib.meta_rows()))


def test_rom_eval_refuses_a_malformed_slot(seg_lib, dev):
    """A segment spec whose table does not fit the slot is refused by the
    C entry point (no launch)."""
    from repro_torch.kernels.interp import kernel as ik

    bad = list(ik.slot_args(seg_lib, "tanh"))
    bad[9] = 12  # a 4096-cell table in a 42-row slot
    codes = torch.zeros(8, dtype=torch.int32, device=dev)
    real = ik.slot_args
    try:
        ik.slot_args = lambda library, kind: bad
        with pytest.raises(RuntimeError, match="rom_eval"):
            rom_eval_cuda(codes, seg_lib, "tanh")
    finally:
        ik.slot_args = real


@pytest.mark.parametrize("gdtype", GAMMA_DTYPES)
@pytest.mark.parametrize("rows,d,dtype", RMS_SHAPES + [(4, 2048,
                                                        torch.float32)])
def test_rmsnorm_kernel_on_segmented_library(rows, d, dtype, gdtype, seg_lib,
                                             dev):
    _check_rmsnorm(rows, d, dtype, seg_lib, dev, gdtype)


@pytest.mark.parametrize("case", ["masked_f32", "unaligned_view"])
def test_rmsnorm_masked_body_on_segmented_library(case, seg_lib, dev):
    rows, d, dtype, body, view = {
        "masked_f32": (7, 1000, torch.float32, "masked", None),
        "unaligned_view": (5, 4096, torch.bfloat16, None, "x")}[case]
    _check_rmsnorm(rows, d, dtype, seg_lib, dev, torch.bfloat16, body=body,
                   view=view)


@pytest.mark.parametrize("rows,d,dtype,view", [
    (4, 64, torch.float32, False), (511, 64, torch.float32, False),
    (3, 1500, torch.bfloat16, False), (8, 4096, torch.bfloat16, False),
    (16384, 512, torch.float32, False), (1, 8192, torch.bfloat16, False),
    (2, 32768, torch.float32, False), (3, 4095, torch.bfloat16, False),
    (5, 4096, torch.bfloat16, True)])
def test_softmax_kernel_on_segmented_library(rows, d, dtype, view, seg_lib,
                                             dev):
    _check_softmax(rows, d, dtype, seg_lib, dev, view)


@pytest.mark.parametrize("mode,dtype", [("decode", torch.bfloat16),
                                        ("decode_dead", torch.bfloat16),
                                        ("prefill_g1", torch.bfloat16),
                                        ("small", torch.float32)])
def test_flash_kernel_on_segmented_library(mode, dtype, seg_lib, dev):
    _check_flash(mode, dtype, seg_lib, dev)


def _seg_per_forward(cfg) -> dict:
    """The uniform library's launches per forward: a segmented slot's
    activation is the same one act_lib launch (no extra launch for the
    segment decode)."""
    return _per_forward(cfg)


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_fused_and_plain_numerics_agree_on_segmented_library(arch, seg_lib,
                                                             dev):
    cfg, params = _smoke(dev, arch)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    build.reset_launches()
    got, _ = tf.prefill(params, toks, cfg, FusedInterpNumerics(seg_lib), 64)
    assert build.LAUNCHES == _seg_per_forward(cfg)
    want, _ = tf.prefill(params, toks, cfg, PlainFusedNumerics(seg_lib), 64)
    assert build.LAUNCHES == _seg_per_forward(cfg)  # plain: no launches
    tol = 4 * 2.0 ** -12 * want.abs().max()
    assert torch.all((got - want).abs() <= tol)
    codes = torch.arange(4096, dtype=torch.int32, device=dev)
    for kind in seg_lib.kinds:
        assert torch.equal(FusedInterpNumerics(seg_lib)._eval(kind)(codes),
                           PlainFusedNumerics(seg_lib)._eval(kind)(codes))


def test_engine_on_segmented_library_counts(seg_lib, dev):
    cfg, params = _smoke(dev, "deepseek_moe_16b")
    eng = ServeEngine(cfg, params, slots=2, cache_len=32, library=seg_lib,
                      horizon=4, device=dev)
    rng = np.random.default_rng(0)
    for i, n in enumerate((5, 11, 3)):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, n
                                           ).astype(np.int32), max_new=5))
    assert len(eng.run()) == 3
    forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
    assert eng.stats["launches"] == {
        k: n * forwards for k, n in _seg_per_forward(cfg).items()}


# ------------------------------------------------- per-table kernels (*_tab)

TAB_SETS = ("R6", "R5", "10b")


@pytest.fixture(scope="module")
def tab_designs():
    """set -> {kind: design} for exp2neg, recip and rsqrt, generated into a
    fresh cache directory: the default 12-bit R6 tables (those the default
    library packs), 12-bit R5 ones and 10-bit ones."""
    kw = {"R6": {}, "R5": {"lookup_bits": 5}, "10b": {"bits": 10}}
    with tempfile.TemporaryDirectory() as d:
        gen = Explorer(ExploreConfig(device="cpu", cache_dir=d))
        return {name: {k: gen.get_table(k, **kw[name])
                       for k in ("exp2neg", "recip", "rsqrt")}
                for name in TAB_SETS}


@pytest.mark.parametrize("rows,d,dtype,view", [
    (4, 64, torch.float32, False), (37, 1000, torch.bfloat16, False),
    (3, 1500, torch.float32, False), (5, 33, torch.bfloat16, False),
    (16384, 512, torch.float32, False), (1, 8192, torch.bfloat16, False),
    (2, 32768, torch.float32, False), (3, 4095, torch.bfloat16, False),
    (5, 4096, torch.bfloat16, True)])
@pytest.mark.parametrize("dset", TAB_SETS)
def test_softmax_tab_matches_plain(dset, rows, d, dtype, view, tab_designs,
                                   dev):
    ed, rd = tab_designs[dset]["exp2neg"], tab_designs[dset]["recip"]
    x = _softmax_inputs(rows, d, dtype, dev, view)
    n0 = build.LAUNCHES["softmax_tab"]
    got, e = softmax_tab_cuda(x, ed, rd, return_e=True)
    assert torch.equal(approx_softmax_fused(x, ed, rd), got)
    assert build.LAUNCHES["softmax_tab"] == n0 + 2
    ec, rc = ed.device_coeffs(dev), rd.device_coeffs(dev)
    want = fused_softmax_ref(x, ec, rc, _meta(ed), _meta(rd)).float()
    _, e_ref = softmax_exp(x, ec, _meta(ed))
    assert got.dtype == dtype and torch.equal(e, e_ref)
    assert torch.equal(got, kernel_order_softmax(
        x, ec, rc, _meta(ed), _meta(rd), *_twin_shape(x)))
    tol = 2.0 ** -(rd.in_bits - 1) + (2.0 ** -7 if dtype == torch.bfloat16
                                      else 0.0)
    got = got.float()
    assert torch.all((got - want).abs() <= tol * want.abs() + 1e-30)


@pytest.mark.parametrize("rows,d,dtype", [(4, 4096, torch.bfloat16),
                                          (7, 1000, torch.float32),
                                          (5, 64, torch.float32)])
@pytest.mark.parametrize("dset", TAB_SETS)
def test_rmsnorm_tab_matches_plain(dset, rows, d, dtype, tab_designs, dev):
    sd = tab_designs[dset]["rsqrt"]
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, d, device=dev, generator=g) * \
        torch.rand(rows, 1, device=dev, generator=g) * 10
    # rows of +-0.5, 1, 2: mean(x^2) exact in any order, the same rsqrt code
    x[:2] = torch.tensor([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], device=dev)[
        torch.randint(0, 6, (2, d), device=dev, generator=g)]
    x = x.to(dtype)
    gamma = torch.rand(d, device=dev, generator=g) + 0.5
    n0 = build.LAUNCHES["rmsnorm_tab"]
    got = approx_rmsnorm_fused(x, gamma, sd).float()
    assert build.LAUNCHES["rmsnorm_tab"] == n0 + 1
    want = fused_rmsnorm_ref(x, gamma, sd.device_coeffs(dev),
                             _meta(sd)).float()
    assert torch.equal(got[:2], want[:2])
    tol = 2 * 2.0 ** -(sd.out_bits - 1) + (2.0 ** -7 if dtype ==
                                           torch.bfloat16 else 0.0)
    assert torch.all((got - want).abs() <= tol * want.abs() + 1e-30)


def _tab_case(case, dev, dtype):
    """q, k, v (B, S, H, D) and causal: Yi-6B's causal 512-token prefill
    (32 heads, K/V expanded from 4 by the caller) and a non-causal decode
    query against 1024 keys; small ragged cases (Sq != Sk, top-left causal
    alignment; a ragged last key tile)."""
    g = torch.Generator(device=dev).manual_seed(3)
    kw = dict(device=dev, dtype=dtype)
    b, sq, sk, h, kvh, d, causal = {
        "prefill": (1, 512, 512, 32, 4, 128, True),
        "decode": (4, 1, 1024, 32, 4, 128, False),
        "ragged": (2, 37, 100, 3, 3, 16, True),
        "wide": (1, 70, 45, 2, 2, 64, False)}[case]
    q = torch.randn(b, sq, h, d, generator=g, **kw)
    k = torch.randn(b, sk, kvh, d, generator=g, **kw)
    v = torch.randn(b, sk, kvh, d, generator=g, **kw)
    k, v = (t.repeat_interleave(h // kvh, dim=2) for t in (k, v))
    return q, k, v, causal


@pytest.mark.parametrize("case,dtype", [("prefill", torch.bfloat16),
                                        ("decode", torch.bfloat16),
                                        ("ragged", torch.float32),
                                        ("wide", torch.bfloat16)])
@pytest.mark.parametrize("dset", TAB_SETS)
def test_flash_tab_matches_plain(dset, case, dtype, tab_designs, dev):
    ed, rd = tab_designs[dset]["exp2neg"], tab_designs[dset]["recip"]
    q, k, v, causal = _tab_case(case, dev, dtype)
    kw = dict(causal=causal, exp_design=ed, recip_design=rd)
    n0 = build.LAUNCHES["flash_attn_tab"]
    got = attention_fused(q, k, v, **kw).float()
    assert build.LAUNCHES["flash_attn_tab"] == n0 + 1
    bound = softmax_ulp_bound(ed, rd)
    vmax = v.float().abs().max()
    tq, splits = _tiles(q, k, v)
    twin = attention_fused_ref(q, k, v, ed, rd, causal=causal, block_k=64,
                               block_q=tq, kv_splits=splits).float()
    tight = bound * vmax
    if dtype == torch.bfloat16:
        tight = tight + 2.0 ** -8 * twin.abs()
    err = (got - twin).abs()
    assert torch.all(err <= tight), float(err.max())
    want = attention_fused_ref(q, k, v, ed, rd, causal=causal).float()
    tol = ((k.shape[1] + 63) // 64 + 2) * bound * vmax
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * (vmax + want.abs())
    err = (got - want).abs()
    assert torch.all(err <= tol), float(err.max())


@pytest.mark.parametrize("kernel", ["softmax", "rmsnorm", "flash"])
def test_tab_equals_lib_bitwise_on_default_designs(kernel, tab_designs, lib,
                                                   dev):
    """The default library packs the R6 designs: each per-table kernel
    equals its library twin bitwise (the same rows, the same body)."""
    d6 = tab_designs["R6"]
    for k, dz in d6.items():  # the tables the library packs
        assert torch.equal(dz.device_coeffs(dev),
                           lib.coeffs[lib.func_id(k), :len(dz.a)])
    g = torch.Generator(device=dev).manual_seed(7)
    if kernel == "softmax":
        for rows, d, dtype in ((4, 64, torch.float32),
                               (9, 3000, torch.bfloat16)):
            x = (torch.randn(rows, d, device=dev, generator=g) * 4).to(dtype)
            assert torch.equal(approx_softmax_fused(x, d6["exp2neg"],
                                                    d6["recip"]),
                               approx_softmax_library(x, lib))
        for rows, d, dtype, view in SOFTMAX_SHAPES:
            x = _softmax_inputs(rows, d, dtype, dev, view, seed=7)
            assert torch.equal(approx_softmax_fused(x, d6["exp2neg"],
                                                    d6["recip"]),
                               approx_softmax_library(x, lib))
            assert torch.equal(
                softmax_tab_cuda(x, d6["exp2neg"], d6["recip"],
                                 body="masked"),
                softmax_lib_cuda(x, lib, body="masked"))
    elif kernel == "rmsnorm":
        from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_lib_cuda,
                                                        rmsnorm_tab_cuda)

        for rows, d, dtype in [(5, 4096, torch.bfloat16)] + RMS_SHAPES:
            for gdtype in GAMMA_DTYPES:
                x, gamma, _ = _rms_inputs(rows, d, dtype, dev, gdtype,
                                          seed=7)
                assert torch.equal(approx_rmsnorm_fused(x, gamma,
                                                        d6["rsqrt"]),
                                   approx_rmsnorm_library(x, gamma, lib))
        x, gamma, _ = _rms_inputs(7, 1000, torch.float32, dev, seed=7)
        assert torch.equal(
            rmsnorm_tab_cuda(x, gamma, d6["rsqrt"], body="masked"),
            rmsnorm_lib_cuda(x, gamma, lib, body="masked"))
    else:
        for case in ("prefill", "decode", "ragged"):
            q, k, v, causal = _tab_case(case, dev, torch.bfloat16)
            assert torch.equal(
                attention_fused(q, k, v, causal=causal,
                                exp_design=d6["exp2neg"],
                                recip_design=d6["recip"]),
                attention_fused_library(q, k, v, lib, causal=causal))


def _const_design(r: int) -> TableDesign:
    """An exp2neg-shaped design of 2^r rows reading 2^13 everywhere (16-bit
    codes, 13 output bits)."""
    meta = CoeffMeta(14, 0, True)
    zeros = np.zeros(1 << r, np.int64)
    return TableDesign("const", 16, 13, r, 0, 1, 0, 0, zeros, zeros,
                       zeros + 8192, meta, meta, meta)


def test_softmax_tab_shared_memory_limit(tab_designs, dev):
    """Staged tables past 48 KB take the opt-in shared memory (2^13 rows,
    96 KB); two 2^14-row tables (384 KB) exceed a block's and raise instead
    of being read from global memory."""
    rd = tab_designs["R6"]["recip"]
    x = torch.randn(8, 300, device=dev) * 3
    big = _const_design(13)
    got = approx_softmax_fused(x, big, rd)
    want = fused_softmax_ref(x, big.device_coeffs(dev), rd.device_coeffs(dev),
                             _meta(big), _meta(rd))
    tol = 2.0 ** -(rd.in_bits - 1)
    assert torch.all((got - want).abs() <= tol * want.abs() + 1e-30)
    huge = _const_design(14)
    n0 = build.LAUNCHES["softmax_tab"]
    with pytest.raises(RuntimeError, match="softmax_tab"):
        approx_softmax_fused(x, huge, huge)
    assert build.LAUNCHES["softmax_tab"] == n0


def test_flash_tab_shared_memory_limit(tab_designs, dev):
    """The flash body stages both tables next to its K/V ring; two 2^14-row
    tables exceed a block's shared memory, and the launch is refused
    (raises, counts nothing) instead of reading the tables from global
    memory."""
    q, k, v, causal = _tab_case("ragged", dev, torch.bfloat16)
    huge = _const_design(14)
    n0 = build.LAUNCHES["flash_attn_tab"]
    with pytest.raises(RuntimeError, match="flash_attn_tab"):
        attention_fused(q, k, v, causal=causal, exp_design=huge,
                        recip_design=huge)
    assert build.LAUNCHES["flash_attn_tab"] == n0


@pytest.mark.parametrize("mode", ["decode", "prefill_g1"])
def test_flash_kernel_captures_in_a_cuda_graph(mode, lib, dev):
    """Neither the split path (workspace, combine kernel) nor the one-split
    path syncs with the host: a CUDA graph captures the wrapper, and its
    replay equals the eager call bitwise."""
    q, k, v, q_pos, kv_pos, window = _flash_case(mode, dev, torch.bfloat16)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=window)
    want = attention_fused_library(q, k, v, lib, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = attention_fused_library(q, k, v, lib, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ------------------------------------------ the fused activation (act_lib)

ACT_LIBS = ("uniform", "segmented", "window6")


def _act_inputs(meta, seed=0):
    """Every code of ``meta``'s slot (the centre of each code cell, both of
    its edges and their float32 neighbours), the window's ends, hi - 1e-6
    and their neighbours, +-inf, NaN and 3 * randn: an odd count (a vector
    tail)."""
    c = np.arange(1 << meta.in_bits, dtype=np.float64)
    lo, hi = meta.act_lo, meta.act_hi
    x = np.concatenate([lo + (c + d) * (hi - lo) / (1 << meta.in_bits)
                        for d in (-0.5, 0.0, 0.5)]).astype(np.float32)
    sp = np.array([lo, hi, hi - 1e-6, np.inf, -np.inf, np.nan], np.float32)
    x = np.concatenate([x, sp])
    x = np.concatenate([x, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf)),
                        3 * np.random.default_rng(seed).standard_normal(
                            4095).astype(np.float32)])
    assert len(x) % 2
    return x


def _act_lib(name, lib, seg_lib):
    if name == "uniform":
        return lib
    if name == "segmented":
        return seg_lib
    from repro_torch.api.library import (DEFAULT_LIBRARY_KINDS,
                                         DEFAULT_TABLE_KEY, TABLES_DIR)

    designs = [TableDesign.from_dict(json.loads(
        (TABLES_DIR / f"{k}_{DEFAULT_TABLE_KEY}.json").read_text()))
        for k in DEFAULT_LIBRARY_KINDS]
    return InterpLibrary.from_designs(designs, DEFAULT_LIBRARY_KINDS,
                                      act_windows={"silu": (-6.0, 6.0)},
                                      device=lib.device)


def _bits(t):
    return t.float().cpu().numpy().view(np.int32)


@pytest.mark.parametrize("body", ["datapath", "table"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ACT_LIBS)
def test_act_lib_bitwise_eager_chain_and_plain(name, dtype, body, lib,
                                               seg_lib, dev):
    """Every activation slot: one act_lib launch equals the eager chain
    (the glue on the card around the int32 kernel), the plain version on
    the card and the glue on the CPU, bitwise, at every code's cell edges,
    the window's ends, +-inf, NaN and an odd element count; the eager
    chain's divide by the window's span is a true divide on the card too
    (the (-6, 6) window's span is no power of two). ``table``: the inputs
    39 times over, 1598103 elements, past the 384 per code (1572864) from
    which the kernel evaluates a uniform slot into a table of outputs
    first (16 per code on a segmented one)."""
    from repro_torch.kernels.interp.ops import act_library
    from repro_torch.numerics.ops import InterpNumerics

    card = _act_lib(name, lib, seg_lib)
    host = InterpLibrary(card.coeffs.cpu(), card.metas)
    for kind in ("silu", "sigmoid", "softplus", "gelu", "tanh"):
        x = _act_inputs(card.meta(kind))
        if body == "table":
            x = np.tile(x, 39)
        x = torch.from_numpy(x).to(dev, dtype)
        n0 = dict(build.LAUNCHES)
        got = FusedInterpNumerics(card)._act(kind, x)
        assert build.LAUNCHES["act_lib"] == n0["act_lib"] + 1
        assert sum(build.LAUNCHES.values()) == sum(n0.values()) + 1
        assert got.dtype == dtype and got.shape == x.shape
        chain = InterpNumerics(card)._act(kind, x)
        plain = PlainFusedNumerics(card)._act(kind, x)
        cpu = InterpNumerics(host)._act(kind, x.cpu())
        for want in (chain, plain, cpu, act_library(x, card, kind)):
            assert np.array_equal(_bits(got), _bits(want)), (name, kind)


@pytest.mark.parametrize("name", ["uniform", "segmented"])
def test_act_lib_misaligned_view_and_empty(name, lib, seg_lib, dev):
    """A contiguous view that starts 2 bytes past a 16-byte boundary (the
    scalar path) and an empty tensor: the eager chain's values, no launch
    for the empty one."""
    from repro_torch.numerics.ops import InterpNumerics

    card = _act_lib(name, lib, seg_lib)
    g = torch.Generator(device=dev).manual_seed(5)
    base = (torch.randn(3 * 11008 + 2, device=dev, generator=g) * 3
            ).to(torch.bfloat16)
    x = base.view(-1)[1:]
    assert x.data_ptr() % 16 and x.is_contiguous()
    got = FusedInterpNumerics(card)._act("silu", x)
    assert torch.equal(got, InterpNumerics(card)._act("silu", x))
    empty = torch.empty(0, 4, device=dev, dtype=torch.bfloat16)
    n0 = dict(build.LAUNCHES)
    out = FusedInterpNumerics(card)._act("silu", empty)
    assert out.shape == (0, 4) and build.LAUNCHES == n0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ACT_LIBS)
def test_act_lib_reads_swiglu_gates_in_place(name, dtype, lib, seg_lib,
                                             dev):
    """The gate and up halves of a SwiGLU product, as the models hand them
    (``torch.chunk`` views: rows at twice their width; Yi-6B's decode
    gate, a routed-expert group's up half, an odd width), and rows at an
    odd stride: read in place (``act_rows`` hands the view itself), one
    act_lib launch through either body, a contiguous result bitwise equal
    to the eager chain and the plain version for all five slots."""
    from repro_torch.kernels.interp import kernel as ik
    from repro_torch.numerics.ops import InterpNumerics

    card = _act_lib(name, lib, seg_lib)
    g = torch.Generator(device=dev).manual_seed(8)
    views = []
    for lead, cols, half in (((4, 1), 11008, 0), ((1, 64), 1408, 1),
                             ((3, 7), 37, 0)):
        h = (torch.randn(*lead, 2 * cols, device=dev, generator=g) * 3
             ).to(dtype)
        views.append(torch.chunk(h, 2, dim=-1)[half])
    views.append((torch.randn(6, 33, device=dev, generator=g) * 3
                  ).to(dtype)[:, :16])
    for x in views:
        assert ik.act_rows(x)[0] is x and not x.is_contiguous()
        for kind in ("silu", "sigmoid", "softplus", "gelu", "tanh"):
            chain = InterpNumerics(card)._act(kind, x)
            plain = PlainFusedNumerics(card)._act(kind, x)
            for body in (None, "datapath", "table"):
                n0 = dict(build.LAUNCHES)
                got = ik.act_library_cuda(x, card, kind, body=body)
                assert build.LAUNCHES["act_lib"] == n0["act_lib"] + 1
                assert sum(build.LAUNCHES.values()) == sum(n0.values()) + 1
                assert got.is_contiguous() and got.shape == x.shape
                assert torch.equal(got, chain), (kind, body, x.shape)
                assert torch.equal(got, plain), (kind, body, x.shape)


def test_act_lib_replays_in_a_cuda_graph(lib, seg_lib, dev):
    """The fused activation makes no host sync: a captured CUDA graph
    replays it bitwise, on both libraries."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn(4, 1, 11008, device=dev, generator=g) * 3
         ).to(torch.bfloat16)
    for card in (lib, seg_lib):
        num = FusedInterpNumerics(card)
        want = num.silu(x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = num.silu(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_act_lib_refuses_what_it_cannot_take(seg_lib, dev):
    """float16, a slot that is no activation and a malformed slot raise,
    and nothing launches."""
    from repro_torch.kernels.interp import kernel as ik

    x = torch.randn(64, device=dev)
    n0 = dict(build.LAUNCHES)
    with pytest.raises(TypeError):
        ik.act_library_cuda(x.half(), seg_lib, "silu")
    with pytest.raises(ValueError, match="activation"):
        ik.act_library_cuda(x, seg_lib, "recip")
    bad = list(ik.slot_args(seg_lib, "tanh"))
    bad[9] = 12  # a 4096-cell table in a 42-row slot
    real = ik.slot_args
    try:
        ik.slot_args = lambda library, kind: bad
        ik._act_operands.cache_clear()
        with pytest.raises(RuntimeError, match="act_lib"):
            ik.act_library_cuda(x, seg_lib, "tanh")
    finally:
        ik.slot_args = real
        ik._act_operands.cache_clear()
    assert build.LAUNCHES == n0


@pytest.mark.parametrize("name", ["uniform", "segmented"])
def test_int32_one_id_staging_at_an_odd_count(name, lib, seg_lib, dev):
    """library_eval and library_walk with one id (the one-slot staging)
    on an odd code count and on a view 4 bytes past a 16-byte boundary:
    the plain version's values for every slot."""
    card = _act_lib(name, lib, seg_lib)
    g = torch.Generator(device=dev).manual_seed(7)
    base = torch.randint(0, 4096, (3 * 4096 + 6,), dtype=torch.int32,
                         device=dev, generator=g)
    walk, dp = card.walk_rows()
    for codes in (base[:-1], base[1:-2]):
        assert codes.numel() % 2
        for kind in card.kinds:
            fid = card.func_id(kind)
            fids = torch.full_like(codes, fid)
            want = library_walk_ref(codes, fids, card.coeffs, walk, dp)
            assert torch.equal(library_walk(codes, fid, card.coeffs, walk,
                                            dp), want), kind
            assert torch.equal(card.eval_int(codes, kind), want), kind
            if not card.segmented_kinds:
                assert torch.equal(library_eval(codes, fid, card.coeffs,
                                                card.meta_rows()), want)


# ------------------------------ the one-slot reads (rom_eval, interp_eval)

ONE_SLOT = ("rom_uniform", "rom_segmented", "interp")


def _one_slot(name, _seg_cpu, dev):
    """(call, plain, oracle, counter) of one one-slot read: ``rom_eval`` on
    the silu slot of the uniform or the segmented library (through
    ``kernels.interp.ops.rom_eval``), or ``interp_eval`` on the vendored
    recip design (through ``table_eval``). ``oracle`` is eval_int on the
    CPU, for codes in range."""
    from repro_torch.api.library import DEFAULT_TABLE_KEY, TABLES_DIR
    from repro_torch.kernels.interp.ref import rom_eval_ref

    if name == "interp":
        d = TableDesign.from_dict(json.loads(
            (TABLES_DIR / f"recip_{DEFAULT_TABLE_KEY}.json").read_text()))
        dp = dict(eval_bits=d.eval_bits, k=d.k, sq_trunc=d.sq_trunc,
                  lin_trunc=d.lin_trunc, degree=d.degree)
        return (lambda c: table_eval(c, d),
                lambda c: interp_eval_ref(c, d.device_coeffs(dev), **dp),
                lambda c: torch.from_numpy(d.eval_int(c.cpu().numpy())),
                "interp_eval")
    host = (InterpLibrary.default_library("cpu") if name == "rom_uniform"
            else _seg_cpu)
    card = InterpLibrary(host.coeffs.to(dev), host.metas).seal()
    m = card.meta("silu")
    args = dict(fid=card.func_id("silu"), r_max=card.r_max,
                eval_bits=m.eval_bits, k=m.k, sq_trunc=m.sq_trunc,
                lin_trunc=m.lin_trunc, degree=m.degree, seg=m.seg_spec())
    return (lambda c: rom_eval(c, card, "silu"),
            lambda c: rom_eval_ref(c, card.coeffs.reshape(-1, 3), **args),
            lambda c: host.eval_int(c.cpu(), "silu"), "rom_eval")


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [4097, 4098, 4099, 0])
@pytest.mark.parametrize("name", ONE_SLOT)
def test_one_slot_tails_offset_views_and_empty(name, n, offset, _seg_cpu,
                                               dev):
    """A count with n % 4 in {1, 2, 3} (the scalar tail after the vectors),
    a view 4 bytes past a 16-byte boundary (the scalar path alone) and an
    empty call: bitwise the plain version and eval_int, one launch per call
    (none for an empty one)."""
    call, plain, oracle, counter = _one_slot(name, _seg_cpu, dev)
    g = torch.Generator(device=dev).manual_seed(n + offset)
    base = torch.randint(0, 4096, (n + 8,), dtype=torch.int32, device=dev,
                         generator=g)
    codes = base[offset:offset + n]
    assert not n or codes.data_ptr() % 16 == 4 * offset
    n0 = build.LAUNCHES[counter]
    got = call(codes)
    torch.cuda.synchronize()
    assert build.LAUNCHES[counter] == n0 + (1 if n else 0)
    assert got.shape == codes.shape and got.dtype == torch.int32
    assert torch.equal(got, plain(codes))
    assert torch.equal(got.cpu().to(torch.int64), oracle(codes).to(
        torch.int64))


@pytest.mark.parametrize("name", ONE_SLOT)
def test_one_slot_reads_out_of_range_codes_as_zero(name, _seg_cpu, dev):
    """Codes past 2^in_bits and negative codes (a region or cell past the
    slot) read a zero row, 0, as the kernels did before; the codes in range
    beside them equal the plain version."""
    call, plain, _, counter = _one_slot(name, _seg_cpu, dev)
    inside = torch.arange(0, 4096, 7, dtype=torch.int32, device=dev)
    outside = torch.tensor([4096, 4097, 65535, 2**31 - 1, -1, -4096, -2**31],
                           dtype=torch.int32, device=dev)
    codes = torch.cat([inside, outside, inside.flip(0)])
    n0 = build.LAUNCHES[counter]
    got = call(codes)
    torch.cuda.synchronize()
    assert build.LAUNCHES[counter] == n0 + 1
    k = inside.numel()
    assert torch.equal(got[:k], plain(inside))
    assert torch.equal(got[-k:], plain(inside.flip(0)))
    assert not got[k:k + outside.numel()].any()


@pytest.mark.parametrize("name", ONE_SLOT)
def test_one_slot_replays_in_a_cuda_graph(name, _seg_cpu, dev):
    """The one-slot reads make no host sync: a captured CUDA graph replays
    the call bitwise the eager one (one launch counted at capture)."""
    call, _, _, counter = _one_slot(name, _seg_cpu, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    codes = torch.randint(0, 4096, (4, 1, 11008), dtype=torch.int32,
                          device=dev, generator=g)
    want = call(codes)
    torch.cuda.synchronize()
    n0 = build.LAUNCHES[counter]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call(codes)
    assert build.LAUNCHES[counter] == n0 + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("r", [14, 15])
def test_interp_eval_rows_past_shared_memory(r, dev):
    """A synthetic 16-bit design of 2^r int32-fitting rows: 2^14 rows (192
    KB) stage in the opt-in shared memory, 2^15 (384 KB) pass a block's
    227 KB and are read in global memory. Every code, and a view at a
    4-byte offset, bitwise eval_int and the plain version, one launch a
    call."""
    rng = np.random.default_rng(r)
    meta = CoeffMeta(24, 0, True)
    d = TableDesign("rows", 16, 20, r, 4, 2, 0, 0,
                    rng.integers(-2**10, 2**10, 1 << r),
                    rng.integers(-2**16, 2**16, 1 << r),
                    rng.integers(-2**24, 2**24, 1 << r), meta, meta, meta)
    assert d.fits_int32
    coeffs = d.device_coeffs(dev)
    dp = dict(eval_bits=d.eval_bits, k=d.k, sq_trunc=d.sq_trunc,
              lin_trunc=d.lin_trunc, degree=d.degree)
    codes = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    for c in (codes, codes[1:-2]):
        n0 = build.LAUNCHES["interp_eval"]
        got = table_eval(c, d)
        torch.cuda.synchronize()
        assert build.LAUNCHES["interp_eval"] == n0 + 1
        assert torch.equal(got, interp_eval_ref(c, coeffs, **dp))
        np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64),
                                      d.eval_int(c.cpu().numpy()))


# --------------------------------------- the serving control layer's tick

def _serve_on(eng, prompts, max_new=6):
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new=max_new))
    return {r.rid: list(r.out) for r in eng.run()}


def _prompts_for(cfg, lengths=(5, 11, 3, 8, 2), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_graph_tick_equals_eager_tick_bitwise(arch, lib, dev):
    """The same requests on a graph engine (one CUDA graph replay per tick)
    and an eager one: token streams and the caches afterwards (k, v, pos)
    bitwise equal; both count per-forward launches times forwards in
    ``stats["launches"]``, and the graph engine's replays leave the global
    counters to its prefills."""
    cfg, params = _smoke(dev, arch, "bfloat16")
    prompts = _prompts_for(cfg)
    out, engines = {}, {}
    for graph in (True, False):
        eng = ServeEngine(cfg, params, slots=2, cache_len=64, library=lib,
                          horizon=4, graph=graph, device=dev)
        build.reset_launches()
        out[graph] = _serve_on(eng, prompts)
        torch.cuda.synchronize()
        engines[graph] = (eng, dict(build.LAUNCHES))
    g, e = engines[True][0], engines[False][0]
    assert out[True] == out[False]
    for a, b in zip(g.caches, e.caches):
        assert torch.equal(a, b)
    assert g.stats["graph"] is True and g.stats["captures"] == 3
    assert e.stats["graph"] is False and e.stats["captures"] == 0
    per = _per_forward(cfg)
    for eng, glob in engines.values():
        forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
        assert eng.stats["launches"] == {k: n * forwards
                                         for k, n in per.items()}
    assert engines[False][1] == e.stats["launches"]
    assert engines[True][1] == {k: n * g.stats["prefills"]
                                for k, n in per.items()}
    for key in ("ticks", "decode_steps", "dispatches", "transfers"):
        assert g.stats[key] == e.stats[key]
    assert g.stats["dispatches"] == g.stats["ticks"]


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b",
                                  "minicpm3_4b", "mixtral_8x22b"])
def test_fused_tick_makes_no_host_sync(arch, lib, dev):
    """A warm eager tick over live slots under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation of the decode
    -> argmax -> feed-back loop reads the device from the host (what a
    capture needs)."""
    cfg, params = _smoke(dev, arch, "bfloat16")
    eng = ServeEngine(cfg, params, slots=2, cache_len=64, library=lib,
                      horizon=4, graph=False, device=dev)
    for i, p in enumerate(_prompts_for(cfg, (5, 9))):
        eng.submit(Request(i, p, max_new=20))
    eng.step(4)
    tick = eng._tick_fn(4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tick(eng.params, eng._tok, eng._pos, eng._live, eng.caches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_graph_recaptures_after_a_library_swap(lib, dev):
    """Assigning ``engine.library`` mid-run drops the graphs: the next tick
    recaptures over the new ROM. A ROM with one flipped bit in a silu row
    (no verification armed) serves exactly the tokens an eager engine with
    the same swap serves, and not those of the unswapped engine."""
    from repro_torch.faults import flip_rom_bit

    cfg, params = _smoke(dev, "yi_6b")
    prompts = _prompts_for(cfg, (5, 11))
    f, r_max = lib.func_id("silu"), lib.r_max
    bit = ((f * r_max + r_max // 2) * 3 + 2) * 32 + 24
    bad = flip_rom_bit(lib, bit=bit)
    outs = {}
    for graph, swap in ((True, True), (False, True), (True, False)):
        eng = ServeEngine(cfg, params, slots=2, cache_len=64, library=lib,
                          horizon=4, graph=graph, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new=12))
        eng.step(4)
        n = eng.stats["captures"]
        if swap:
            eng.library = bad
            assert eng.numerics.library is bad
        eng.run()
        outs[graph, swap] = {r.rid: r.out for r in eng.finished}
        if graph:  # after a swap, each chunk size is captured anew
            assert (eng.stats["captures"] > n) == swap
            assert eng._graph_key[2] is (bad if swap else lib)
    assert outs[True, True] == outs[False, True]
    assert outs[True, True] != outs[True, False]


def test_graph_launch_counts_under_replay(lib, seg_lib, dev):
    """Launches per forward hold on ``stats["launches"]`` under replay, on
    both libraries, through every chunk size (1, 2, 4, 8)."""
    cfg, params = _smoke(dev, "deepseek_moe_16b", "bfloat16")
    for card in (lib, seg_lib):
        eng = ServeEngine(cfg, params, slots=3, cache_len=64, library=card,
                          horizon=8, device=dev)
        _serve_on(eng, _prompts_for(cfg, (4, 7, 2, 9)), max_new=16)
        forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
        assert eng.stats["launches"] == {
            k: n * forwards for k, n in _per_forward(cfg).items()}
        assert eng.stats["captures"] == 4


def test_uncapturable_configuration_stays_eager(dev):
    """Exact numerics over 32768 cache rows take the attention glue's chunk
    liveness test (a host read) at decode: the engine ticks eagerly and
    says why; it still serves what a graph engine at a short cache
    serves."""
    cfg, params = _smoke(dev, "yi_6b")
    cfg = cfg.replace(numerics="exact")
    long = ServeEngine(cfg, params, slots=2, cache_len=32768, horizon=4,
                       device=dev)
    assert long.stats["graph"] is False
    assert "decode_reads_host" in long.stats["graph_reason"]
    short = ServeEngine(cfg, params, slots=2, cache_len=64, horizon=4,
                        device=dev)
    assert short.stats["graph"] is True
    prompts = _prompts_for(cfg, (5, 3))
    assert _serve_on(long, prompts, 4) == _serve_on(short, prompts, 4)


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_serial_oracle_equals_graph_tick_on_exact_numerics(arch, dev):
    """The serial path (one decode and a host argmax per token) and the
    graph tick decode the same tokens with exact numerics."""
    cfg, params = _smoke(dev, arch, "bfloat16")
    cfg = cfg.replace(numerics="exact")
    prompts = _prompts_for(cfg)
    outs = {}
    for fused in (True, False):
        eng = ServeEngine(cfg, params, slots=2, cache_len=64, horizon=4,
                          fused=fused, device=dev)
        outs[fused] = _serve_on(eng, prompts)
        assert eng.stats["graph"] is fused
    assert outs[True] == outs[False]


def test_card_fault_ladder(lib, dev):
    """On the card: a ROM flip at construction serves exact tokens; NaN
    ticks retire the slots and, past the watchdog limit, move the engine
    to the serial rung with guarded numerics, which finishes the rest
    through the library kernels."""
    from repro_torch.faults import TickFaultInjector, flip_rom_bit
    from repro_torch.numerics.guard import GuardedNumerics

    cfg, params = _smoke(dev, "yi_6b", "bfloat16")
    prompts = _prompts_for(cfg, (5, 7, 4))
    eng = ServeEngine(cfg, params, slots=2, cache_len=64, device=dev,
                      library=flip_rom_bit(lib, seed=5))
    assert eng.cfg.numerics == "exact" and eng.stats["rom_faults"] == 1
    exact = ServeEngine(cfg.replace(numerics="exact"), params, slots=2,
                        cache_len=64, device=dev)
    assert _serve_on(eng, prompts) == _serve_on(exact, prompts)
    eng = ServeEngine(cfg, params, slots=1, cache_len=64, library=lib,
                      watchdog_limit=2, device=dev)
    TickFaultInjector("nan", every_n=1, limit=2).install(eng)
    before = build.LAUNCHES["library_eval"]
    _serve_on(eng, prompts, 4)
    assert [r.error for r in eng.failed] == ["non_finite_output"] * 2
    assert eng.fused is False and eng.cfg.numerics == "interp-guarded"
    assert isinstance(eng.numerics, GuardedNumerics)
    assert [r.rid for r in eng.finished] == [2]
    assert build.LAUNCHES["library_eval"] > before


@pytest.mark.parametrize("kind", ["gelu", "sigmoid", "softplus", "tanh"])
def test_new_activations_through_act_lib(kind, lib, seg_lib, dev):
    """The backends' gelu / sigmoid / softplus / tanh on the card: one
    act_lib launch each, bitwise the plain version, at the served decode
    and prefill shapes, on both libraries."""
    g = torch.Generator(device=dev).manual_seed(3)
    for card in (lib, seg_lib):
        for shape in ((4, 1, 11008), (1, 512, 11008)):
            x = (torch.randn(shape, device=dev, generator=g) * 4
                 ).to(torch.bfloat16)
            n0 = build.LAUNCHES["act_lib"]
            got = getattr(FusedInterpNumerics(card), kind)(x)
            assert build.LAUNCHES["act_lib"] == n0 + 1
            want = getattr(PlainFusedNumerics(card), kind)(x)
            assert torch.equal(got, want)


# ------------------------------- plans, AOT admission graphs, host pipeline

@pytest.fixture(scope="module")
def _r5_cpu():
    """The default manifest at lookup_bits=5 (the R5 plan slot)."""
    with tempfile.TemporaryDirectory() as d:
        return Explorer(ExploreConfig(device="cpu", cache_dir=d)
                        ).compile(lookup_bits=5)


def _plan_libs(dev, lib, seg_lib, r5_cpu):
    return {"default": lib, "hier": seg_lib,
            "R5": InterpLibrary(r5_cpu.coeffs.to(dev), r5_cpu.metas).seal()}


def _three_slot_plan(n_layers):
    """Layer 0 on the R5 slot, layer 1 on the segmented (hier) slot, every
    other layer and ``rest`` on the default slot, all interp-fused."""
    from repro_torch.plan import LayerAssign, NumericsPlan, SiteAssign, SlotSpec

    def la(slot):
        return LayerAssign(*(SiteAssign("interp-fused", slot),) * 3)
    rest = la(SlotSpec())
    return NumericsPlan(
        layers=(la(SlotSpec(lookup_bits=5)), la(SlotSpec(
            segmentation="hier"))) + (rest,) * (n_layers - 2), rest=rest)


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_plan_graph_tick_equals_plan_eager_tick(arch, lib, seg_lib, _r5_cpu,
                                                dev):
    """A three-slot plan (R5, hier, default) on a graph engine and an eager
    one: streams and final caches bitwise equal, launches per forward as
    the homogeneous engine's (every layer reads its own library)."""
    cfg, params = _smoke(dev, arch, "bfloat16")
    cfg = cfg.replace(plan=_three_slot_plan(cfg.n_layers))
    prompts = _prompts_for(cfg)
    engines = {}
    for graph in (True, False):
        eng = ServeEngine(cfg, params, slots=2, cache_len=64, horizon=4,
                          library=_plan_libs(dev, lib, seg_lib, _r5_cpu),
                          graph=graph, device=dev)
        assert eng.stats["graph"] is graph
        engines[graph] = (eng, _serve_on(eng, prompts))
    (g, out_g), (e, out_e) = engines[True], engines[False]
    assert out_g == out_e
    for a, b in zip(g.caches, e.caches):
        assert torch.equal(a, b)
    per = _per_forward(cfg)
    for eng in (g, e):
        forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
        assert eng.stats["launches"] == {k: n * forwards
                                         for k, n in per.items()}


def test_plan_tick_makes_no_host_sync(lib, seg_lib, _r5_cpu, dev):
    cfg, params = _smoke(dev, "deepseek_moe_16b", "bfloat16")
    cfg = cfg.replace(plan=_three_slot_plan(cfg.n_layers))
    eng = ServeEngine(cfg, params, slots=2, cache_len=64, horizon=4,
                      library=_plan_libs(dev, lib, seg_lib, _r5_cpu),
                      graph=False, device=dev)
    for i, p in enumerate(_prompts_for(cfg, (5, 9))):
        eng.submit(Request(i, p, max_new=20))
    eng.step(4)
    tick = eng._tick_fn(4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tick(eng.params, eng._tok, eng._pos, eng._live, eng.caches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b",
                                  "minicpm3_4b"])
def test_packed_admission_makes_no_host_sync(arch, lib, dev):
    """The packed admission body (prefill_padded, the splice of every row
    into its slot, the first tokens into the slot state) over device
    inputs under ``set_sync_debug_mode("error")``: nothing a capture of it
    replays reads the device from the host."""
    cfg, params = _smoke(dev, arch, "bfloat16")
    eng = ServeEngine(cfg, params, slots=4, cache_len=64, library=lib,
                      graph=False, aot_buckets=(16,), device=dev)
    host = np.zeros(4 * 16 + 8, np.int64)
    prompts, lens, slots = eng._admit_views(host, 16, 4)
    for i, n in enumerate((3, 16, 7, 12)):
        prompts[i, :n] = np.arange(n) % cfg.vocab_size
        lens[i], slots[i] = n, 3 - i
    inp = torch.from_numpy(host).to(dev)
    views = eng._admit_views(inp, 16, 4)
    firsts = torch.zeros(4, dtype=torch.int64, device=dev)
    eng._admit_body(*views, torch.zeros_like(firsts), eng.caches, eng._tok,
                    eng._pos, eng._live)  # warm: builds, workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            eng._admit_body(*views, firsts, eng.caches, eng._tok, eng._pos,
                            eng._live)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng._live.all() and eng._pos.tolist() == [12, 7, 16, 3]


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b",
                                  "minicpm3_4b"])
def test_packed_admission_graph_equals_eager(arch, lib, dev):
    """The same requests through AOT engines with graphs (each packed
    admission one replay) and without: streams and final caches bitwise,
    zero misses, one capture per (bucket, pack) plus the ticks, and
    ``stats["launches"]`` per forward on both (a packed admission is one
    forward)."""
    from repro_torch.serve import aot

    cfg, params = _smoke(dev, arch, "bfloat16")
    prompts = _prompts_for(cfg, (5, 11, 3, 8, 2, 16, 14, 9, 30))
    engines = {}
    for graph in (True, False):
        eng = ServeEngine(cfg, params, slots=4, cache_len=64, library=lib,
                          horizon=4, graph=graph, aot_buckets=(8, 16),
                          max_pack=4, device=dev)
        engines[graph] = (eng, _serve_on(eng, prompts))
    (g, out_g), (e, out_e) = engines[True], engines[False]
    assert out_g == out_e
    for a, b in zip(g.caches, e.caches):
        assert torch.equal(a, b)
    table = aot.BucketTable((8, 16))
    assert g.stats["captures"] == aot.compile_count(table, 4, 4, 4)
    assert g.stats["admit_replays"] == g.stats["packed_admits"] > 0
    assert g.stats["aot_fallbacks"] == 1  # the 30-token prompt
    for eng in (g, e):
        assert eng.stats["aot_misses"] == 0
        assert eng.stats["packed_requests"] == 8
        forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
        assert eng.stats["launches"] == {
            k: n * forwards for k, n in _per_forward(cfg).items()}


def test_packed_admission_agrees_with_exact_length_in_the_tie_band(lib, dev):
    """Packed admission (other GEMM row counts than exact-length prefills)
    against the engine without buckets: first tokens inside the 2^-5
    max-logit tie band of a plain-version prefill."""
    cfg, params = _smoke(dev, "yi_6b", "bfloat16")
    prompts = _prompts_for(cfg, (5, 11, 3, 8))
    eng = ServeEngine(cfg, params, slots=4, cache_len=64, library=lib,
                      aot_buckets=(16,), device=dev)
    got = _serve_on(eng, prompts, 1)
    plain = PlainFusedNumerics(lib)
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            t = torch.as_tensor(p, dtype=torch.int64, device=dev)[None]
            logits, _ = tf.prefill(params, t, cfg, plain, 64)
            lg = logits[0, -1].float()
            gap = float(lg.max() - lg[got[i][0]])
            assert gap <= 2.0 ** -5 * float(lg.abs().max()), (i, gap)


def test_slot_library_swap_recaptures(lib, seg_lib, _r5_cpu, dev):
    """Replacing one entry of a plan engine's library dict in place drops
    the graphs (tick and admission) and rebinds the numerics: the next
    step recaptures over the new ROM and layer 0 reads it."""
    cfg, params = _smoke(dev, "yi_6b", "bfloat16")
    cfg = cfg.replace(plan=_three_slot_plan(cfg.n_layers))
    libs = _plan_libs(dev, lib, seg_lib, _r5_cpu)
    eng = ServeEngine(cfg, params, slots=2, cache_len=64, horizon=4,
                      library=libs, aot_buckets=(8,), device=dev)
    for i, p in enumerate(_prompts_for(cfg, (5, 7))):
        eng.submit(Request(i, p, max_new=12))
    eng.step(4)
    n = eng.stats["captures"]
    other = InterpLibrary(libs["R5"].coeffs.clone(), libs["R5"].metas).seal()
    eng.library["R5"] = other
    eng.step(4)
    assert eng.stats["captures"] > n
    assert eng.numerics.for_layer(0).library is other
    assert any(x is other for x in eng._graph_key)
    eng.run()
    assert all(len(r.out) == 12 for r in eng.finished)


def test_async_host_on_the_card(lib, dev, tmp_path):
    """``async_host=True`` with graphs and AOT buckets: the pinned-ring
    hand-off gives the synchronous engine's streams, and its journal
    resumes (all done: nothing replayed)."""
    from repro_torch.serve.journal import load_requests

    cfg, params = _smoke(dev, "yi_6b", "bfloat16")
    prompts = _prompts_for(cfg, (5, 11, 3, 8, 2, 16))
    outs = {}
    for async_host in (False, True):
        jp = tmp_path / f"j{int(async_host)}.jsonl"
        eng = ServeEngine(cfg, params, slots=3, cache_len=64, library=lib,
                          horizon=4, aot_buckets=(8, 16), device=dev,
                          async_host=async_host, pipeline_depth=2,
                          journal=str(jp))
        outs[async_host] = _serve_on(eng, prompts, 9)
        eng.close()
        assert {rid: st.out for rid, st in load_requests(jp).items()} == \
            outs[async_host]
    assert outs[True] == outs[False]
    res = ServeEngine.resume(str(tmp_path / "j1.jsonl"), cfg, params,
                             slots=3, cache_len=64, library=lib, device=dev)
    assert res.stats["resume_skipped_done"] == len(prompts)


# ------------------------------------------- the decoder families' shapes

FAMILIES = ["minicpm3_4b", "mixtral_8x22b", "qwen1_5_110b", "minitron_8b",
            "internvl2_2b"]


@pytest.mark.parametrize("mode", ["mla_decode", "mla_prefill", "ring",
                                  "ring_w3000", "qwen_decode"])
def test_flash_kernel_at_family_shapes(mode, lib, dev):
    """flash_attn_lib where the new families take it: MLA's Dk 96 / Dv 64
    with g = 1 over 40 heads and V a strided view (decode with key splits,
    a 511-token prefill), Mixtral's wrapped window ring (rows not ordered
    by position; windows 4096 and 3000; key splits cut rows), Qwen's 64
    heads over 8; the tolerances of ``test_flash_kernel_matches_plain``."""
    q, k, v, *_ = _flash_case(mode, dev, torch.bfloat16)
    if mode.startswith("mla"):
        assert not v.is_contiguous() and v.data_ptr() % 16 == 0
    if mode != "mla_prefill":
        assert _tiles(q, k, v)[1] > 1 or mode == "mla_decode"
    _check_flash(mode, torch.bfloat16, lib, dev)


@pytest.mark.parametrize("gdtype", GAMMA_DTYPES)
@pytest.mark.parametrize("rows,d", [(4, 768), (4, 256), (511, 768),
                                    (511, 256), (4, 2560), (4, 6144),
                                    (4, 8192)])
def test_rmsnorm_kernel_at_family_widths(rows, d, gdtype, lib, dev):
    """MLA's q_norm (768) and kv_norm (256) at decode and prefill, and the
    residual norms of MiniCPM3 (2560), Mixtral (6144) and Qwen (8192)."""
    _check_rmsnorm(rows, d, torch.bfloat16, lib, dev, gdtype)


@pytest.mark.parametrize("rows", [4, 64, 4104])
def test_softmax_kernel_router_rows_of_8(rows, lib, dev):
    """Mixtral's router: rows of 8 experts in float32 (decode, a tick's
    rows, a windowed prefill)."""
    _check_softmax(rows, 8, torch.float32, lib, dev)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_smoke_prefill_through_kernels_matches_plain(arch, lib, dev):
    cfg, params = _smoke(dev, arch)
    n = cfg.sliding_window + 8 if cfg.sliding_window else 33
    toks = torch.randint(0, cfg.vocab_size, (2, n), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    build.reset_launches()
    got, cache = tf.prefill(params, toks, cfg, FusedInterpNumerics(lib), 64)
    assert build.LAUNCHES == _per_forward(cfg)
    want, want_cache = tf.prefill(params, toks, cfg, PlainFusedNumerics(lib),
                                  64)
    tol = 4 * 2.0 ** -12 * want.abs().max()
    assert torch.all((got - want).abs() <= tol)
    assert torch.equal(cache.pos, want_cache.pos)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_graph_tick_equals_eager_tick_bitwise(arch, lib, dev):
    """``test_graph_tick_equals_eager_tick_bitwise`` on the new families in
    bf16 (Mixtral's smoke prompts pass its 32-token window and decode past
    the wrap): streams and caches bitwise, per-forward launches."""
    cfg, params = _smoke(dev, arch, "bfloat16")
    w = cfg.sliding_window
    prompts = _prompts_for(cfg, (w + 8, 11, w - 2) if w else (5, 11, 3))
    out, engines = {}, {}
    for graph in (True, False):
        eng = ServeEngine(cfg, params, slots=2, cache_len=64, library=lib,
                          horizon=4, graph=graph, device=dev)
        out[graph] = _serve_on(eng, prompts, max_new=9)
        engines[graph] = eng
    g, e = engines[True], engines[False]
    assert out[True] == out[False] and g.stats["graph"] is True
    for a, b in zip(g.caches, e.caches):
        assert torch.equal(a, b)
    if w:
        assert g.caches.pos.shape[-1] == w
    per = _per_forward(cfg)
    for eng in engines.values():
        forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
        assert eng.stats["launches"] == {k: n * forwards
                                         for k, n in per.items()}
    for i, p in enumerate(prompts):  # batching invisible on the card
        solo = ServeEngine(cfg, params, slots=1, cache_len=64, library=lib,
                           horizon=4, device=dev)
        assert _serve_on(solo, [p], max_new=9)[0] == out[True][i]


# ------------------------------------------------ the SSM mixer and hybrid

SSM_ARCHS = ["mamba2_130m", "jamba_v0_1_52b"]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_prefill_and_decode_through_kernels_match_plain(arch, lib, dev):
    """A two-chunk prefill (64 tokens at the smoke chunk of 32) and one
    decode step through the kernels against ``PlainFusedNumerics``: the
    logits within 4 * 2^-12 * max|logit|, the SSM state (conv window and
    recurrent state) within 4 * 2^-12 of its largest magnitude, the
    launches of each forward (``library_eval`` for the recurrence's
    exp_neg: four in the prefill, one in the decode)."""
    cfg, params = _smoke(dev, arch)
    toks = torch.randint(0, cfg.vocab_size, (2, 2 * cfg.ssm.chunk),
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    fused, plain = FusedInterpNumerics(lib), PlainFusedNumerics(lib)
    build.reset_launches()
    got, cache = tf.prefill(params, toks, cfg, fused, 96)
    torch.cuda.synchronize()
    assert build.LAUNCHES == _per_forward(cfg, "prefill")
    want, want_cache = tf.prefill(params, toks, cfg, plain, 96)

    def close(a, b):
        assert torch.all((a - b).abs() <= 4 * 2.0 ** -12 * b.abs().max())

    close(got, want)
    for a, b in zip(tf.cache_leaves(cache), tf.cache_leaves(want_cache)):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            close(a, b)
    tok = want[:, -1].argmax(-1)[:, None]
    pos = torch.full((2,), toks.shape[1], dtype=torch.int32, device=dev)
    build.reset_launches()
    got, _ = tf.decode_step(params, tok, pos, cache, cfg, fused)
    torch.cuda.synchronize()
    assert build.LAUNCHES == _per_forward(cfg, "decode")
    want, _ = tf.decode_step(params, tok, pos, want_cache, cfg, plain)
    close(got, want)
    close(cache.ssm.ssm, want_cache.ssm.ssm)


def test_ssm_graph_tick_equals_eager_tick_bitwise(lib, dev):
    """Mamba2's smoke config in bf16 on a graph engine and an eager one:
    the decode reads nothing on the host (no K/V rows to read), so it
    captures; streams and every cache leaf (the conv windows and the
    float32 recurrent states) bitwise equal; per-forward launches, the
    prefills' and the decodes' apart."""
    cfg, params = _smoke(dev, "mamba2_130m", "bfloat16")
    prompts = _prompts_for(cfg, (5, 32, 3, 11))
    out, engines = {}, {}
    for graph in (True, False):
        eng = ServeEngine(cfg, params, slots=2, cache_len=64, library=lib,
                          horizon=4, graph=graph, device=dev)
        out[graph] = _serve_on(eng, prompts, max_new=9)
        engines[graph] = eng
    g, e = engines[True], engines[False]
    assert out[True] == out[False]
    assert g.stats["graph"] is True and g.stats["graph_reason"] is None
    assert g.caches.kv is None and g.stats["captures"] == 3
    for a, b in zip(tf.cache_leaves(g.caches), tf.cache_leaves(e.caches)):
        assert torch.equal(a, b)
    pre, dec = _per_forward(cfg, "prefill"), _per_forward(cfg)
    for eng in engines.values():
        assert eng.stats["launches"] == {
            k: pre[k] * eng.stats["prefills"]
            + dec[k] * eng.stats["decode_steps"] for k in dec}


@pytest.mark.parametrize("d", [1536, 8192])
def test_rmsnorm_kernel_gated_norm_f32_gamma(d, lib, dev):
    """The SSM mixer's gated norm: bf16 rows of d_inner (Mamba2 1536,
    Jamba 8192) with the float32 scale the mixer passes, at decode and at
    a 512-token prefill."""
    for rows in (4, 512):
        _check_rmsnorm(rows, d, torch.bfloat16, lib, dev, torch.float32)


@pytest.mark.parametrize("shape,dtype,kind", [
    ((4, 24), torch.float32, "softplus"), ((4, 128), torch.float32,
                                           "softplus"),
    ((1, 512, 24), torch.float32, "softplus"),
    ((4, 1792), torch.bfloat16, "silu"), ((4, 8224), torch.bfloat16,
                                          "silu")])
def test_act_lib_at_ssm_shapes(shape, dtype, kind, lib, dev):
    """``act_lib`` where the SSM mixer takes it: dt's softplus in float32
    (heads wide: Mamba2 24, Jamba 128) and the conv output's silu in bf16
    (conv_dim wide: 1792, 8224), bitwise the plain version, one launch."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.randn(shape, device=dev, generator=g) * 4).to(dtype)
    n0 = build.LAUNCHES["act_lib"]
    got = getattr(FusedInterpNumerics(lib), kind)(x)
    assert build.LAUNCHES["act_lib"] == n0 + 1
    assert got.dtype == dtype
    assert torch.equal(got, getattr(PlainFusedNumerics(lib), kind)(x))


# ------------------------------------ the encoder-decoder and VLM frontend

@pytest.mark.parametrize("mode", list(NONCAUSAL))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_non_causal_and_cross(mode, dtype, lib, dev):
    """flash_attn_lib without the causal mask, where Whisper takes it: the
    encoder's self-attention over 100 keys (a ragged last tile of 36) and
    cross attention with every query and key position 0, at 100 keys and
    at the served 1500 (23 x 64 + 28) for one query row (key splits) and
    four; the tolerances of ``test_flash_kernel_matches_plain``."""
    _check_flash(mode, dtype, lib, dev)


@pytest.mark.parametrize("shape", [(4, 1, 1536), (4, 1500, 1536),
                                   (1, 256, 2048)])
def test_act_lib_gelu_at_encdec_and_vlm_shapes(shape, lib, dev):
    """``act_lib`` gelu where Whisper's MLP (1536 wide: a decode step, the
    encoder over 1500 frames) and InternVL's projector (256 patches, 2048
    wide, float32) take it: one launch, bitwise the plain version."""
    dtype = torch.float32 if shape[-1] == 2048 else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    x = (torch.randn(shape, device=dev, generator=g) * 4).to(dtype)
    n0 = build.LAUNCHES["act_lib"]
    got = FusedInterpNumerics(lib).gelu(x)
    assert build.LAUNCHES["act_lib"] == n0 + 1
    assert got.dtype == dtype
    assert torch.equal(got, PlainFusedNumerics(lib).gelu(x))


def test_whisper_smoke_encode_prefill_decode_match_plain(lib, dev):
    """The Whisper smoke config through the kernels against
    ``PlainFusedNumerics``: the encoder over (2, 64, 64) frames, a
    13-token prefill with its output as ``cross`` and one decode step, each
    within 4 * 2^-12 of its largest magnitude, the positions bitwise, the
    launches of each forward (no rmsnorm: LayerNorm reads no table)."""
    cfg, params = _smoke(dev, "whisper_tiny")
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn(2, cfg.encoder.source_len, cfg.d_model,
                         device=dev, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, 13), device=dev,
                         generator=g)
    fused, plain = FusedInterpNumerics(lib), PlainFusedNumerics(lib)

    def close(a, b):
        assert torch.all((a - b).abs() <= 4 * 2.0 ** -12 * b.abs().max())

    build.reset_launches()
    cross = tf.encoder_forward(params["encoder"], frames, cfg, fused)
    torch.cuda.synchronize()
    assert build.LAUNCHES == _per_forward(cfg, "encoder")
    want_cross = tf.encoder_forward(params["encoder"], frames, cfg, plain)
    close(cross, want_cross)
    build.reset_launches()
    got, cache = tf.prefill(params, toks, cfg, fused, 64, cross=cross)
    torch.cuda.synchronize()
    assert build.LAUNCHES == _per_forward(cfg, "prefill")
    want, want_cache = tf.prefill(params, toks, cfg, plain, 64,
                                  cross=want_cross)
    close(got, want)
    assert torch.equal(cache.pos, want_cache.pos)
    tok = want[:, -1].argmax(-1)[:, None]
    pos = torch.full((2,), 13, dtype=torch.int32, device=dev)
    build.reset_launches()
    got, _ = tf.decode_step(params, tok, pos, cache, cfg, fused, cross=cross)
    torch.cuda.synchronize()
    assert build.LAUNCHES == _per_forward(cfg, "decode")
    want, _ = tf.decode_step(params, tok, pos, want_cache, cfg, plain,
                             cross=want_cross)
    close(got, want)
    assert torch.equal(cache.pos, want_cache.pos)


def test_internvl_smoke_prefill_with_patches_matches_plain(lib, dev):
    """The InternVL smoke config through the kernels with its 16 patches
    (float32, projected by a gelu ``act_lib`` launch) against
    ``PlainFusedNumerics``."""
    cfg, params = _smoke(dev, "internvl2_2b")
    g = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn(2, cfg.frontend_len, cfg.frontend_dim, device=dev,
                      generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=dev, generator=g)
    build.reset_launches()
    got, _ = tf.prefill(params, toks, cfg, FusedInterpNumerics(lib), 64,
                        frontend_emb=emb)
    torch.cuda.synchronize()
    per = _per_forward(cfg, "prefill")
    assert build.LAUNCHES == dict(per, act_lib=per["act_lib"] + 1)
    want, _ = tf.prefill(params, toks, cfg, PlainFusedNumerics(lib), 64,
                         frontend_emb=emb)
    assert torch.all((got - want).abs() <= 4 * 2.0 ** -12
                     * want.abs().max())


# ---- the train path (training and checkpoints slice) ---------------------

def _train_setup(dev, numerics="interp"):
    from repro_torch.data import make_batch

    cfg = get_smoke_config("yi_6b").replace(numerics=numerics)
    params = tf.init_params(cfg, 0, "cpu")
    batch = make_batch(cfg, 32, 4)
    return cfg, params, batch


def test_train_step_cuda_kernels_match_cpu_plain(dev):
    """The smoke Yi-6B train step under interp numerics bound to the
    default library: on the card (every table read a ``library_eval``
    launch) against the same step on the CPU (the plain versions): loss
    within 1e-5 relative, grad_norm within 1e-4, from one state and one
    batch; the step launched ``library_eval`` and nothing fused."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepConfig, TrainState, make_train_step
    from repro_torch.util.tree import tree_map

    cfg, params, batch = _train_setup(dev)
    sc = StepConfig(microbatches=2, peak_lr=1e-3, warmup=0)
    out = {}
    for where in ("cpu", dev):
        p = tree_map(lambda t: t.to(where), params)
        state = TrainState(p, adamw_init(p), None)
        step = make_train_step(cfg, sc, InterpLibrary.default_library(where))
        n0 = dict(build.LAUNCHES)
        _, m = step(state, batch, 0)
        out[str(where)] = {k: float(v) for k, v in m.items()}
        out[str(where) + " launches"] = {
            k: v - n0[k] for k, v in build.LAUNCHES.items() if v != n0[k]}
    cpu, cuda = out["cpu"], out[str(dev)]
    assert out["cpu launches"] == {}
    assert set(out[str(dev) + " launches"]) == {"library_eval"}
    np.testing.assert_allclose(cuda["loss"], cpu["loss"], rtol=1e-5)
    np.testing.assert_allclose(cuda["grad_norm"], cpu["grad_norm"],
                               rtol=1e-4)
    assert np.isfinite(cuda["loss"]) and cuda["lr"] == cpu["lr"]


def test_train_step_refuses_fused_on_cuda(dev):
    """A fused backend has no backward: the step raises ``ValueError``
    for CUDA parameters before any kernel launches."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepConfig, TrainState, make_train_step
    from repro_torch.util.tree import tree_map

    cfg, params, batch = _train_setup(dev, "interp-fused")
    p = tree_map(lambda t: t.to(dev), params)
    step = make_train_step(cfg, StepConfig(), InterpLibrary.default_library(
        dev))
    n0 = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="no backward"):
        step(TrainState(p, adamw_init(p), None), batch, 0)
    assert build.LAUNCHES == n0


def test_checkpoint_of_cuda_state_bitwise(dev, tmp_path):
    """A train state on the card saves and restores onto the card, every
    leaf bitwise (bf16 parameters through their uint16 bits)."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.train import train_state_init
    from repro_torch.util.tree import leaves_with_paths

    cfg = get_smoke_config("yi_6b").replace(param_dtype="bfloat16")
    state = train_state_init(cfg, None, 0, dev)
    save(tmp_path, 0, state)
    got, _ = restore(tmp_path, 0, state)
    for (n, a), (_, b) in zip(leaves_with_paths(got),
                              leaves_with_paths(state)):
        assert a.device == b.device and a.dtype == b.dtype, n
        assert torch.equal(a, b), n


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mamba2_130m",
                                  "minicpm3_4b", "whisper_tiny"])
def test_train_step_families_on_cuda(arch, dev):
    """The other families' train paths run their backward on the card
    (the MoE dispatch's index_put and combine gather, the SSD chunk loop,
    MLA, the encoder and cross attention) under ``remat="block"`` and
    interp numerics through ``library_eval``: loss and grad_norm finite
    and within 1e-3 of the CPU plain versions' (float32 products in
    another order can move a table code)."""
    from repro_torch.data import make_batch
    from repro_torch.optim import global_norm
    from repro_torch.train.step import batch_to, loss_and_grads
    from repro_torch.numerics.ops import get_numerics
    from repro_torch.util.tree import tree_map

    cfg = get_smoke_config(arch).replace(numerics="interp")
    params = tf.init_params(cfg, 0, "cpu")
    batch = make_batch(cfg, 64, 2)
    out = {}
    for where in ("cpu", dev):
        num = get_numerics(cfg, InterpLibrary.default_library(where))
        loss, _, grads = loss_and_grads(tree_map(lambda t: t.to(where),
                                                 params),
                                        batch_to(batch, where), cfg, num, 2)
        out[str(where)] = (float(loss), float(global_norm(grads)))
    (lc, gc_), (lg, gg) = out["cpu"], out[str(dev)]
    assert np.isfinite([lg, gg]).all() and gg > 0
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    np.testing.assert_allclose(gg, gc_, rtol=1e-3)


def test_dse_pallas_trials_equal_batched(dev, tmp_path):
    """The 8-bit recip DSE space (``tests/dse/test_study.py``) under
    ``engines=("pallas",)`` on the card (each (spec, R) one
    ``envelopes_parity_batched`` and one ``dd_max_rows`` launch) journals
    the metrics and verdicts of the exact engine's study."""
    import dataclasses

    from repro_torch.dse import SearchSpace, Study

    space = SearchSpace(kinds=("recip",), lookup_bits=(3, 4, 5, 6),
                        targets=("asic", "pallas-tpu"), bits=(8,),
                        fused=(True,), horizons=(4,), batches=(2,))
    got = {}
    for engine in ("batched", "pallas"):
        before = dict(build.LAUNCHES)
        with Study(tmp_path / engine, dataclasses.replace(
                space, engines=(engine,)), measure="none",
                device=dev) as study:
            records = study.run()
        launched = {k: n - before[k] for k, n in build.LAUNCHES.items()
                    if n != before[k]}
        got[engine] = [(r.status, r.metrics, r.objectives)
                       for r in records.values()]
        if engine == "pallas":
            assert launched.get("envelopes_parity_batched", 0) >= 4
            assert launched["dd_max_rows"] >= 4
        else:
            assert not launched
    assert got["pallas"] == got["batched"]


@pytest.fixture
def nccl_world(dev, tmp_path):
    """A world of one rank over NCCL on cuda:0 (a file store: no port)."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0),
                            timeout=datetime.timedelta(seconds=120))
    yield
    dist.destroy_process_group()


def test_world1_nccl_meshed_engine_equals_unmeshed(lib, dev, nccl_world):
    """A ``1 x 1`` NCCL mesh on the smoke Yi-6B (AOT buckets: tick and
    admission graphs): streams, caches and kernel launches bitwise the
    unmeshed engine's; the tick graph holds its collectives (every one is
    issued at world 1 too); a CUDA mesh on a gloo group is refused before
    any launch."""
    from repro_torch.launch.mesh import Mesh, make_serve_mesh

    import torch.distributed as dist

    cfg, params = _smoke(dev, "yi_6b", "bfloat16")
    prompts = _prompts_for(cfg, (5, 11, 3, 8, 2, 16))
    mesh = make_serve_mesh(1, 1)
    engines = {}
    for name, m in (("unmeshed", None), ("meshed", mesh)):
        eng = ServeEngine(cfg, params, slots=4, cache_len=64, library=lib,
                          horizon=4, aot_buckets=(8, 16), max_pack=4,
                          mesh=m, device=dev)
        engines[name] = (eng, _serve_on(eng, prompts))
    (u, out_u), (g, out_g) = engines["unmeshed"], engines["meshed"]
    assert out_g == out_u
    assert g.stats["graph"] and g.stats["aot_misses"] == 0
    assert g.stats["launches"] == u.stats["launches"]
    for a, b in zip(u.caches, g.caches):
        assert torch.equal(a, b)
    tick = g._graphs[4][2]  # the collectives one replay of it runs
    per_step = cfg.n_layers * 2 + 1  # wo, the MLP's wo, the embedding
    assert tick == {"all_reduce": 4 * per_step, "all_gather": 4 * 2,
                    "reduce_scatter": 0}
    assert g.stats["collectives"]["all_reduce"] > 0
    assert u.stats["collectives"] == {"all_reduce": 0, "all_gather": 0,
                                    "reduce_scatter": 0}
    gloo = Mesh(("data", "tp"), (1, 1), ranks=np.zeros((1, 1), np.int64),
                coords={"data": 0, "tp": 0},
                groups={ax: dist.new_group([0], backend="gloo")
                        for ax in ("data", "tp")}, backend="gloo")
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="nccl"):
        ServeEngine(cfg, params, slots=4, cache_len=64, library=lib,
                    mesh=gloo, device=dev)
    assert build.LAUNCHES == before


# ------------------------------------------- the MoE experts' float32 products
def expert_products(monkeypatch) -> list:
    """Each expert product ``moe_block`` takes from here on: (a, b, out)."""
    seen, real = [], moe._mm_f32

    def spy(a, b):
        out = real(a, b)
        seen.append((a, b, out))
        return out

    monkeypatch.setattr(moe, "_mm_f32", spy)
    return seen


def summation_bound(a, b) -> torch.Tensor:
    """K * 2^-24 * (|a| @ |b|): how far a float32 sum of the K exact
    products of a bf16 x bf16 product may land from the exact value, in
    any order; two such sums differ by at most twice that."""
    return a.shape[-1] * 2.0 ** -24 * (a.float().abs() @ b.float().abs())


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mixtral_8x22b"])
@pytest.mark.parametrize("s", [1, 256])
def test_moe_expert_products_are_float32_at_full_width(arch, s, lib, dev,
                                                       monkeypatch):
    """One full-width bf16 MoE layer (4 rows of ``s`` tokens): its peak
    memory stays below one float32 copy of the layer's expert weights
    (cuBLAS reads them as bf16 and writes float32), both expert products
    come out float32 and agree with the float32 product of the upcast
    operands on the card within twice the float32 summation bound."""
    from repro_torch.models.layers import init_tree

    cfg = get_config(arch)
    assert cfg.param_dtype == "bfloat16"
    p = init_tree(moe.moe_shapes(cfg), 3, dev)
    f32_copy = 4 * (p["wi"].numel() + p["wo"].numel())
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(4, s, cfg.d_model, device=dev, generator=g).to(
        torch.bfloat16)
    num = FusedInterpNumerics(lib)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        y = moe.moe_block(p, x, cfg, num)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - held
        assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
        assert peak < f32_copy, (peak, f32_copy)
        seen = expert_products(monkeypatch)
        assert torch.equal(moe.moe_block(p, x, cfg, num), y)
        assert len(seen) == 2
        for a, b, out in seen:
            assert a.dtype == b.dtype == torch.bfloat16
            assert out.dtype == torch.float32
            for e in range(a.shape[0]):  # one expert's float32 copy at once
                err = (out[e] - a[e].float() @ b[e].float()).abs()
                assert torch.all(err <= 2 * summation_bound(a[e], b[e]))


def test_moe_expert_products_captured_bf16_to_float32(lib, dev, monkeypatch):
    """The served bf16 DeepSeekMoE, Mixtral and Jamba smoke models: the
    graph engines capture their ticks and admissions with the float32
    expert products of bf16 operands (each tick replays them), and the
    streams equal the eager engines'."""
    for arch in ("deepseek_moe_16b", "mixtral_8x22b", "jamba_v0_1_52b"):
        cfg, params = _smoke(dev, arch, "bfloat16")
        prompts = _prompts_for(cfg, (5, 11, 3))
        out = {}
        for graph in (True, False):
            seen = expert_products(monkeypatch)
            eng = ServeEngine(cfg, params, slots=2, cache_len=64,
                              library=lib, horizon=4, graph=graph,
                              device=dev)
            if graph:
                assert eng.stats["graph"] and seen
            out[graph] = _serve_on(eng, prompts)
            assert seen and all(
                a.dtype == torch.bfloat16 and o.dtype == torch.float32
                for a, _b, o in seen)
        assert out[True] == out[False], arch


def test_bf16_moe_train_step_on_cuda(dev):
    """One bf16 DeepSeekMoE smoke train step on the card (interp numerics
    through ``library_eval``; the experts' products through
    ``expert_mm``'s backward): finite loss and gradient norm, the expert
    weights bf16 and moved."""
    from repro_torch.data import make_batch
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepConfig, TrainState, make_train_step
    from repro_torch.util.tree import leaves_with_paths

    cfg = get_smoke_config("deepseek_moe_16b").replace(
        numerics="interp", param_dtype="bfloat16")
    params = tf.init_params(cfg, 0, dev)
    wi0 = params["segments"]["seg1"]["0"]["ffn"]["wi"].clone()
    step = make_train_step(cfg, StepConfig(peak_lr=1e-3, warmup=0),
                           InterpLibrary.default_library(dev))
    state, m = step(TrainState(params, adamw_init(params), None),
                    make_batch(cfg, 32, 2), 0)
    assert np.isfinite([float(m["loss"]), float(m["grad_norm"])]).all()
    assert float(m["grad_norm"]) > 0
    wi = dict(leaves_with_paths(state.params))
    moved = [t for n, t in wi.items() if n.endswith("ffn/wi")]
    assert moved and all(t.dtype == torch.bfloat16 for t in moved)
    assert not torch.equal(state.params["segments"]["seg1"]["0"]["ffn"][
        "wi"], wi0)


@functools.lru_cache(maxsize=None)
def _train_parity():
    """``tools/train_parity.py``, loaded by path."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "train_parity.py"
    spec = importlib.util.spec_from_file_location("train_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_train_family_on_card_matches_cpu(arch, dev, record_property):
    """The smoke family's bf16 ``loss_and_grads`` under exact numerics on
    the card against the port on the CPU (``tools/train_parity.py``): every
    flipped MoE route a near tie, then the loss, aux loss and every
    gradient leaf within twice the CPU's own bf16 error; one train step
    from the same state, routed as the CPU's (``step_parity``): the loss
    and aux as above, the learning rate equal, the gradient norm, the
    moments and the float32 master within what that gradient bound
    allows (2 lr only where the gradient's sign is a tie), the bf16
    parameters the master cast and at most 1% of them apart."""
    tp = _train_parity()
    fam = tp.family_parity(arch, dev)
    assert fam["ok"], fam
    step = tp.step_parity(arch, dev)
    record_property("family", fam)
    record_property("step", step)
    assert step["ok"], step


def _interp_grads(arch, dev, numerics):
    from repro_torch.data import make_batch
    from repro_torch.train.step import batch_to, loss_and_grads
    from repro_torch.util.tree import leaves_with_paths, tree_map

    cfg, params = _train_parity().smoke_model(arch)
    cfg = cfg.replace(numerics="interp")
    p = tree_map(lambda t: t.to(dev), params)
    build.reset_launches()
    loss, _aux, grads = loss_and_grads(p, batch_to(make_batch(cfg, 32, 2),
                                                   dev), cfg, numerics)
    return float(loss), dict(build.LAUNCHES), {
        n: g.float() for n, g in leaves_with_paths(grads)}


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b",
                                  "mamba2_130m"])
def test_bf16_interp_train_through_library_eval(arch, lib, dev):
    """Under interp numerics the train path reads every table through
    ``library_eval`` inside autograd (the table reads pass no gradient):
    its bf16 loss bitwise the same path's with the plain evaluator on the
    card, every gradient within one bf16 ulp of its leaf's largest
    magnitude (autograd's index backward adds in no fixed order)."""
    from repro_torch.numerics.ops import InterpNumerics

    class PlainInterp(InterpNumerics):
        _eval = PlainFusedNumerics._eval

    loss, launches, grads = _interp_grads(arch, dev, InterpNumerics(lib))
    p_loss, p_launches, p_grads = _interp_grads(arch, dev, PlainInterp(lib))
    assert launches["library_eval"] > 0 and not any(p_launches.values())
    assert loss == p_loss
    for name, g in grads.items():
        top = float(p_grads[name].abs().max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top else 0.0
        assert float((g - p_grads[name]).abs().max()) <= ulp, name


def _layer_error(fn, params, x, dev):
    """max |card bf16 - CPU float32| over twice max |CPU bf16 - CPU
    float32| for ``fn(params, x)``'s output, the input's gradient and
    every parameter's (a seeded float32 weight on the output), the same
    bf16-valued tensors at both dtypes."""
    from repro_torch.util.tree import leaves_with_paths, tree_map

    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    runs = {}
    for name, d, dt in (("card", dev, torch.bfloat16),
                        ("cpu", torch.device("cpu"), torch.bfloat16),
                        ("cpu32", torch.device("cpu"), torch.float32)):
        p = tree_map(lambda t: t.to(d, torch.float32 if dt == torch.float32
                                    else t.dtype).requires_grad_(), params)
        xi = x.to(d, dt).requires_grad_()
        y = fn(p, xi, dt)
        leaves = [xi] + [t for _, t in leaves_with_paths(p)]
        gs = torch.autograd.grad((y.float() * w.to(d)).sum(), leaves,
                                 allow_unused=True)
        runs[name] = [y.detach().float().cpu()] + [
            torch.zeros(t.shape) if g is None else g.float().cpu()
            for g, t in zip(gs, leaves)]
    worst = 0.0
    for a, b, c in zip(runs["card"], runs["cpu"], runs["cpu32"]):
        own = float((b - c).abs().max())
        err = float((a - c).abs().max())
        worst = max(worst, 0.0 if err == 0 else err / (2 * own))
    return worst


def test_full_width_yi_block_bf16_fwd_bwd_on_card(dev):
    """One full-width Yi-6B block (d 4096, 32 / 4 heads, d_ff 11008) at bf16
    on the card, forward and backward over 64 tokens under exact
    numerics: its output, the input's and every weight's gradient within
    twice the CPU's own bf16 error."""
    from repro_torch.numerics.ops import get_numerics

    cfg = get_config("yi_6b").replace(n_layers=1)
    seg, j, r, _ci, kind = tf.layer_slots(cfg)[0]
    lp = tf.init_params(cfg, seed=0, device="cpu")["segments"][seg][j]
    if r is not None:
        lp = {k: v[r] for k, v in lp.items()}
    x = torch.randn(1, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    pos = torch.arange(64, dtype=torch.int32)[None]

    def block(p, xi, dt):
        c = cfg.replace(param_dtype="float32" if dt == torch.float32
                        else "bfloat16")
        return tf.apply_layer(p, kind, xi, pos.to(xi.device), c,
                              get_numerics("exact"), "train")[0]

    assert _layer_error(block, lp, x, dev) <= 1


def test_full_width_deepseek_moe_layer_bf16_fwd_bwd_on_card(dev):
    """One full-width DeepSeekMoE-16B MoE block (64 experts of d_expert
    1408 over d 2048, top 6, two shared) at bf16 on the card, forward and
    backward over 64 tokens under exact numerics: every token whose
    expert set differs from the CPU's bf16 block's at a near tie (gap
    within the max |card - CPU| router probability), then, routed as the
    CPU routes, the output, the input's and every weight's gradient within
    twice the CPU's own bf16 error."""
    from repro_torch.numerics.ops import get_numerics

    cfg = get_config("deepseek_moe_16b").replace(n_layers=2)
    seg, j, r, _ci, kind = tf.layer_slots(cfg)[1]
    assert kind.ffn == "moe"
    lp = tf.init_params(cfg, seed=0, device="cpu")["segments"][seg][j]
    if r is not None:
        lp = {k: v[r] for k, v in lp.items()}
    x = torch.randn(1, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    tp = _train_parity()
    cpu, card = tp.ForcedRoutes(), tp.ForcedRoutes()
    with torch.no_grad():
        with cpu:
            moe.moe_block(lp["ffn"], x, cfg, get_numerics("exact"))
        with card:
            moe.moe_block({k: v.to(dev) for k, v in lp["ffn"].items()},
                          x.to(dev), cfg, get_numerics("exact"))
    f = tp.flips_at(cpu.probs[0], cpu.ids_seen[0], card.probs[0],
                    card.ids_seen[0], cfg.moe.top_k)
    assert (f["gaps"] <= f["dprob"]).all(), f

    def block(p, xi, dt):
        c = cfg.replace(param_dtype="float32" if dt == torch.float32
                        else "bfloat16")
        with tp.ForcedRoutes([cpu.ids_seen[0]], upto=1):
            return moe.moe_block(p, xi, c, get_numerics("exact"))

    assert _layer_error(block, lp["ffn"], x, dev) <= 1
