"""The served activation (``FusedInterpNumerics._act``): on a CUDA tensor
one ``act_lib`` launch, on the CPU the float glue around the plain table
read, which is the kernel's plain version (``PlainFusedNumerics._act``,
``kernels.interp.ops.act_library``). Held here, on the CPU, against the
reference's ``InterpNumerics._act`` (JAX on the CPU: ``_range_glue`` and
``_act_tails`` around ``lib.eval_int``).

Libraries: the default (uniform) one, the default manifest segmented by
each package (``f775a828748d4ea9``) and the default tables under a silu
window of (-6, 6), whose span is no power of two (the glue's divide is not
a multiply by a power of two there).

Tolerances: bitwise, for all five activation slots in bfloat16 and float32
at every code's cell centre and edges (and their float32 neighbours), the
window's ends, hi - 1e-6 and its neighbours, +-inf, NaN and 3 * randn. The
smoke Yi-6B and DeepSeekMoE forwards under ``PlainFusedNumerics`` give the
logits of the glue as it was before its divide took a device scalar,
bitwise.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.api.library import InterpLibrary as JaxLibrary
from repro.numerics.ops import InterpNumerics as JaxInterpNumerics
from repro_torch.api import spec_for
from repro_torch.api.library import (DEFAULT_LIBRARY_KINDS,
                                     DEFAULT_TABLE_KEY, TABLES_DIR,
                                     InterpLibrary)
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.table import TableDesign
from repro_torch.kernels.interp import kernel as ik
from repro_torch.kernels.interp.ops import act_library
from repro_torch.models import transformer as tf
from repro_torch.numerics import ops as nops
from repro_torch.numerics.ops import (FusedInterpNumerics, InterpNumerics,
                                      PlainFusedNumerics)
from repro_torch.segment import explore_segmented

ACT_KINDS = ("silu", "sigmoid", "softplus", "gelu", "tanh")
WINDOW6 = {"silu": (-6.0, 6.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniform_designs():
    return [TableDesign.from_dict(json.loads(
        (TABLES_DIR / f"{k}_{DEFAULT_TABLE_KEY}.json").read_text()))
        for k in DEFAULT_LIBRARY_KINDS]


@pytest.fixture(scope="module")
def libs():
    """name -> (port library, reference library)."""
    seg = InterpLibrary.from_designs(
        [explore_segmented(spec_for(k), max_depth=6, engine="batched",
                           device="cpu") for k in DEFAULT_LIBRARY_KINDS],
        DEFAULT_LIBRARY_KINDS, device="cpu")
    jex = default_explorer()
    jseg = jex.compile_segmented()
    assert seg.rom_sha() == "f775a828748d4ea9" == jseg.rom_sha()
    window = InterpLibrary.from_designs(_uniform_designs(),
                                        DEFAULT_LIBRARY_KINDS,
                                        act_windows=WINDOW6, device="cpu")
    jwindow = JaxLibrary.from_designs(
        [jex.get_table(k) for k in DEFAULT_LIBRARY_KINDS],
        DEFAULT_LIBRARY_KINDS, act_windows=WINDOW6)
    return {"uniform": (InterpLibrary.default_library("cpu"),
                        jex.compile()),
            "segmented": (seg, jseg), "window6": (window, jwindow)}


def _inputs(meta, seed=0) -> np.ndarray:
    """Every code of ``meta``'s slot (the centre of each code cell, both of
    its edges and their float32 neighbours), the window's ends, hi - 1e-6
    and their neighbours, +-inf, NaN and 3 * randn."""
    c = np.arange(1 << meta.in_bits, dtype=np.float64)
    lo, hi = meta.act_lo, meta.act_hi
    x = np.concatenate([lo + (c + d) * (hi - lo) / (1 << meta.in_bits)
                        for d in (-0.5, 0.0, 0.5)]).astype(np.float32)
    sp = np.array([lo, hi, hi - 1e-6, np.inf, -np.inf, np.nan], np.float32)
    x = np.concatenate([x, sp])
    x = np.concatenate([x, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf))])
    return np.concatenate([x, 3 * np.random.default_rng(seed)
                           .standard_normal(4097).astype(np.float32)])


def _bits(t) -> np.ndarray:
    return np.asarray(t, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ACT_KINDS)
@pytest.mark.parametrize("name", ["uniform", "segmented", "window6"])
def test_plain_act_bitwise_reference(name, kind, dtype, libs):
    """The fused activation's plain version (and the fused and unfused
    backends on the CPU) equals the reference's ``InterpNumerics._act``
    bitwise, tails included."""
    lib, jlib = libs[name]
    x32 = _inputs(lib.meta(kind))
    x = torch.from_numpy(x32).to(getattr(torch, dtype))
    xj = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    want = _bits(JaxInterpNumerics(jlib)._act(kind, xj).astype(jnp.float32))
    outs = (act_library(x, lib, kind), PlainFusedNumerics(lib)._act(kind, x),
            FusedInterpNumerics(lib)._act(kind, x),
            InterpNumerics(lib)._act(kind, x))
    for got in outs:
        assert got.dtype == x.dtype and got.shape == x.shape
        np.testing.assert_array_equal(_bits(got.float().numpy()), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [(-8.0, 8.0), (-6.0, 6.0),
                                    (-6.1, 5.3)])
def test_kernel_glue_constants_are_the_glues(window, dtype):
    """``act_lib``'s host-side constants are what the glue rounds: lo,
    f32(hi - 1e-6), f32(hi - lo), f32(span / 2^out_bits), lo and hi in x's
    dtype (torch's own rounding of the comparison's scalar), and each
    kind's tails (``act_tail_values``)."""
    lib = InterpLibrary.from_designs(
        _uniform_designs(), DEFAULT_LIBRARY_KINDS,
        act_windows={k: window for k in ACT_KINDS}, device="cpu")
    lo, hi = window
    for kind in ACT_KINDS:
        m = lib.meta(kind)
        slot, glue, top_is_x = ik._act_operands(lib, kind, dtype)
        assert list(slot) == ik.slot_args(lib, kind)
        f32 = np.float32
        want = [f32(lo), f32(hi - 1e-6), f32(hi - lo),
                f32(m.act_span / (1 << m.out_bits)),
                torch.tensor([lo], dtype=dtype).item(),
                torch.tensor([hi], dtype=dtype).item(),
                1.0 if kind in ("sigmoid", "tanh") else 0.0,
                -1.0 if kind == "tanh" else 0.0]
        assert list(glue) == [float(v) for v in want]
        assert top_is_x == (kind not in ("sigmoid", "tanh"))
        # the tails compare in x's dtype (a bf16 x rounds the window's end
        # to bf16): the kernel's float compare against the rounded end
        for end, cmp in ((lo, torch.le), (hi, torch.ge)):
            x = torch.linspace(end - 0.2, end + 0.2, 4001).to(dtype)
            rounded = glue[4] if end == lo else glue[5]
            assert torch.equal(cmp(x, end), cmp(x.float(), rounded))


def _old_range_glue(x, in_bits, out_bits, span, ev, lo=nops.ACT_LO,
                    hi=nops.ACT_HI):
    """The glue as it was before its divide took a device scalar."""
    xc = torch.clamp(x.to(torch.float32), lo, hi - 1e-6)
    codes = nops._quantize((xc - lo) / (hi - lo), in_bits)
    return ev(codes).to(torch.float32) * (span / (1 << out_bits))


@pytest.mark.parametrize("window", [(-8.0, 8.0), (-6.0, 6.0),
                                    (-6.1, 5.3)])
def test_range_glue_divide_unchanged_on_cpu(window):
    """On the CPU the divide by a device scalar is the divide by the host
    scalar it replaced: the same codes bitwise."""
    lo, hi = window
    x = torch.from_numpy(np.concatenate([
        np.linspace(lo - 1, hi + 1, 200001, dtype=np.float32),
        3 * np.random.default_rng(1).standard_normal(10000)
        .astype(np.float32)]))
    ev = lambda c: c  # noqa: E731 -- the codes themselves
    assert torch.equal(nops._range_glue(x, 12, 12, 4096.0, ev, lo, hi),
                       _old_range_glue(x, 12, 12, 4096.0, ev, lo, hi))


@pytest.mark.parametrize("arch,name", [("yi_6b", "uniform"),
                                       ("deepseek_moe_16b", "segmented")])
def test_smoke_forward_logits_as_before(arch, name, libs, monkeypatch):
    """A smoke prefill under ``PlainFusedNumerics`` (bfloat16 weights, so
    the activations see bf16) gives the same logits as with the glue as it
    was, bitwise, and equals the fused backend on the CPU."""
    lib = libs[name][0]
    cfg = get_smoke_config(arch).replace(numerics="interp-fused",
                                         param_dtype="bfloat16")
    params = tf.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13))).long()
    now, _ = tf.prefill(params, toks, cfg, PlainFusedNumerics(lib), 32)
    fused, _ = tf.prefill(params, toks, cfg, FusedInterpNumerics(lib), 32)
    monkeypatch.setattr(nops, "_range_glue", _old_range_glue)
    before, _ = tf.prefill(params, toks, cfg, PlainFusedNumerics(lib), 32)
    assert torch.isfinite(now).all()
    assert torch.equal(now, before) and torch.equal(now, fused)


def _gate(lead, cols, half=0):
    """The gate (half 0) or up (half 1) half of a SwiGLU product, as the
    models take it: ``torch.chunk(h, 2, -1)`` of a (*lead, 2 * cols) h."""
    h = torch.arange(int(np.prod(lead)) * 2 * cols, dtype=torch.float32)
    return torch.chunk(h.reshape(*lead, 2 * cols), 2, dim=-1)[half]


@pytest.mark.parametrize("layout,in_place,rows", [
    ("yi_decode_gate", True, 4), ("yi_prefill_up", True, 512),
    ("moe_routed_gate", True, 4 * 64 * 5), ("odd_cols_gate", True, 21),
    ("contiguous", True, 1), ("one_row_gate", True, 1),
    ("transposed", False, 1), ("strided_last_dim", False, 1)])
def test_act_rows_reads_swiglu_gates_in_place(layout, in_place, rows):
    """``act_lib`` reads a SwiGLU gate half (every shape the served models
    hand it) in place, as rows at a stride of twice their width; a layout
    whose rows are not at one stride is copied contiguous. Either way the
    (rows, cols, stride) it passes address x's elements in order."""
    x = {"yi_decode_gate": lambda: _gate((4, 1), 11008),
         "yi_prefill_up": lambda: _gate((1, 512), 11008, 1),
         "moe_routed_gate": lambda: _gate((4, 64, 5), 1408),
         "odd_cols_gate": lambda: _gate((3, 7), 37),
         "contiguous": lambda: torch.arange(6 * 35.0).reshape(6, 5, 7),
         "one_row_gate": lambda: _gate((1, 1), 2816),
         "transposed": lambda: _gate((3, 4), 8).transpose(0, 1),
         "strided_last_dim": lambda: torch.arange(64.0).reshape(4, 16)[:, ::2],
         }[layout]()
    got, n_rows, cols, stride = ik.act_rows(x)
    assert (got.data_ptr() == x.data_ptr()) == in_place
    assert n_rows == rows and n_rows * cols == x.numel()
    if n_rows > 1:
        assert cols == x.shape[-1] and stride == 2 * cols
    read = got.as_strided((n_rows, cols), (stride, 1), got.storage_offset())
    assert torch.equal(read.reshape(x.shape), x)
