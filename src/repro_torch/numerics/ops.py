"""Numerics backends handed to the model stack, and the per-table
approximate ops (twin of ``repro/numerics/ops.py``).

The float glue (max-subtract, exponent split, power-of-two scaling) mirrors
the reference's operation order; only the integer table reads carry
approximation error. The module-level ``approx_*`` functions take one
``TableDesign`` each (default: the process session's table through
``get_table``) and read it with :func:`table_eval_int`.
``InterpNumerics`` reads a bound library's ROM, or, unbound, resolves each
table through ``get_table`` as those functions do. ``FusedInterpNumerics``
lowers rmsnorm, the attention inner loop, the activations and the softmax
to the library-bound kernels on a CUDA device (their plain versions on the
CPU). ``PlainFusedNumerics`` runs the same fused datapath through the plain
versions on any device: it is the oracle a card run holds the kernel path
against. ``"interp-guarded"`` wraps the unfused backend in
:class:`repro_torch.numerics.guard.GuardedNumerics` (the engine's degraded
rung).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.funcspec import ACT_HI, ACT_LO, act_out_span
from repro_torch.core.table import TableDesign
from repro_torch.kernels.interp.ops import table_eval
from repro_torch.kernels.interp.ref import LOG2E, pow2
from repro_torch.numerics.registry import get_table

_F32 = torch.float32
# the longest key axis the fused attention takes; longer ones run the
# chunked glue path (``models.attention.attention_core``)
FUSED_ATTN_MAX_KEYS = 4096
# the most (query, key) pairs the plain fused attention takes: it forms the
# whole score block, so past this it runs the chunked glue path too
FUSED_ATTN_MAX_PAIRS = 1 << 22
# elements per slice of a plain table read (PlainFusedNumerics)
PLAIN_SLICE = 1 << 24


# The reference's name for one design's exact integer evaluation on int32
# codes: the ``interp_eval`` kernel for CUDA codes, its plain version for CPU
# codes, the native int64 ``interp_eval_wide`` for a design that exceeds
# int32 (``kernels.interp.ops.table_eval`` routes all three).
table_eval_int = table_eval


def _quantize(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Map v in [0, 1) to an input code (round half to even, clamped)."""
    q = torch.round(v * (1 << bits)).to(torch.int32)
    return torch.clamp(q, 0, (1 << bits) - 1)


# ---------------------------------------------------------------------------
# float glue, parameterized over the integer table evaluator ``ev`` (int32
# codes -> integer table output); one implementation of each.
# ---------------------------------------------------------------------------

def _exp_neg_glue(x, in_bits: int, out_bits: int, ev) -> torch.Tensor:
    """exp(x) for x <= 0:  2^(x*log2e) = 2^(-n) * tab(-f)."""
    t = torch.clamp(-x, min=0.0).to(_F32) * LOG2E
    t = torch.clamp(t, max=126.0)
    n = torch.floor(t)
    f = t - n
    codes = _quantize(f, in_bits)
    frac = ev(codes).to(_F32) * (2.0 ** -out_bits)
    return frac * pow2(-n)


def _recip_pos_glue(x, in_bits: int, ev) -> torch.Tensor:
    """1/(m * 2^e) = recip(m) * 2^-e,  m in [1, 2)."""
    m, e = torch.frexp(x.to(_F32))  # m in [0.5, 1)
    m2 = 2.0 * m
    codes = _quantize(m2 - 1.0, in_bits)
    val = ev(codes).to(_F32) * (2.0 ** -(in_bits + 1))
    return val * pow2(1 - e)


def _rsqrt_pos_glue(x, in_bits: int, out_bits: int, ev) -> torch.Tensor:
    """x = v * 4^h, v in [1,4);  rsqrt = tab(v) * 2^-h."""
    m, e = torch.frexp(x.to(_F32))
    e = e.to(torch.int32)
    odd = (e & 1) == 1
    v = torch.where(odd, 2.0 * m, 4.0 * m)
    h = torch.where(odd, torch.div(e - 1, 2, rounding_mode="floor"),
                    torch.div(e - 2, 2, rounding_mode="floor"))
    half = 1 << (in_bits - 1)
    codes = torch.where(odd, _quantize(v - 1.0, in_bits - 1),
                        half + _quantize((v - 2.0) * 0.5, in_bits - 1))
    codes = torch.clamp(codes, 0, (1 << in_bits) - 1).to(torch.int32)
    val = ev(codes).to(_F32) * (2.0 ** -out_bits)
    return val * pow2(-h)


def _range_glue(x, in_bits: int, out_bits: int, span: float, ev,
                lo: float = ACT_LO, hi: float = ACT_HI) -> torch.Tensor:
    """Direct table over [lo, hi): quantize the window, rescale the output."""
    xc = torch.clamp(x.to(_F32), lo, hi - 1e-6)
    # a true divide on every device, as the reference's: ATen's CUDA divide
    # by a host scalar multiplies by its reciprocal, which moves codes where
    # the window's span is not a power of two
    width = torch.full((), hi - lo, dtype=_F32, device=xc.device)
    codes = _quantize((xc - lo) / width, in_bits)
    return ev(codes).to(_F32) * (span / (1 << out_bits))


def act_tail_values(kind: str) -> tuple[float | None, float]:
    """(top, bottom) of :func:`_act_tails`; top None is x itself."""
    return (1.0 if kind in ("sigmoid", "tanh") else None,
            -1.0 if kind == "tanh" else 0.0)


def _act_tails(kind: str, x, y, lo: float = ACT_LO,
               hi: float = ACT_HI) -> torch.Tensor:
    """Outside the table window the activations are linear (right tail) or
    saturate; sigmoid saturates to 1/0, tanh to 1/-1, the rest to x/0."""
    top, bot = act_tail_values(kind)
    top = x if top is None else top
    inner = torch.where(x <= lo, bot, y)
    return torch.where(x >= hi, top, inner).to(x.dtype)


# ---------------------------------------------------------------------------
# per-table entry points (one design each; default: the process session's
# table). They are the unfused oracles of the per-table kernels.
# ---------------------------------------------------------------------------

def _tab(kind: str, design: TableDesign | None) -> TableDesign:
    return design if design is not None else get_table(kind)


def approx_exp_neg(x, design: TableDesign | None = None) -> torch.Tensor:
    """exp(x) for x <= 0 via the exp2neg table; exact power-of-two scaling."""
    d = _tab("exp2neg", design)
    return _exp_neg_glue(x, d.in_bits, d.out_bits,
                         lambda c: table_eval_int(c, d))


def approx_recip_pos(x, design: TableDesign | None = None) -> torch.Tensor:
    d = _tab("recip", design)
    return _recip_pos_glue(x, d.in_bits, lambda c: table_eval_int(c, d))


def approx_rsqrt_pos(x, design: TableDesign | None = None) -> torch.Tensor:
    d = _tab("rsqrt", design)
    return _rsqrt_pos_glue(x, d.in_bits, d.out_bits,
                           lambda c: table_eval_int(c, d))


def _approx_act(kind: str, x, design: TableDesign | None) -> torch.Tensor:
    d = _tab(kind, design)
    y = _range_glue(x, d.in_bits, d.out_bits, act_out_span(kind),
                    lambda c: table_eval_int(c, d))
    return _act_tails(kind, x, y)


def approx_silu(x, design: TableDesign | None = None) -> torch.Tensor:
    return _approx_act("silu", x, design)


def approx_sigmoid(x, design: TableDesign | None = None) -> torch.Tensor:
    return _approx_act("sigmoid", x, design)


def approx_softplus(x, design: TableDesign | None = None) -> torch.Tensor:
    return _approx_act("softplus", x, design)


def approx_gelu(x, design: TableDesign | None = None) -> torch.Tensor:
    return _approx_act("gelu", x, design)


def approx_tanh(x, design: TableDesign | None = None) -> torch.Tensor:
    return _approx_act("tanh", x, design)


def approx_softmax(x, axis: int = -1, exp_design: TableDesign | None = None,
                   recip_design: TableDesign | None = None) -> torch.Tensor:
    """Softmax with the table-backed exponential and normalization
    reciprocal (the unfused glue: ``frexp`` split for 1/sum)."""
    xf = x.to(_F32)
    m = torch.amax(xf, dim=axis, keepdim=True).detach()  # stop_gradient
    e = approx_exp_neg(xf - m, exp_design)
    s = torch.sum(e, dim=axis, keepdim=True)
    return (e * approx_recip_pos(s, recip_design)).to(x.dtype)


def approx_rmsnorm(x, gamma, eps: float = 1e-6,
                   design: TableDesign | None = None) -> torch.Tensor:
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True) + eps
    return (xf * approx_rsqrt_pos(var, design) * gamma).to(x.dtype)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class ExactNumerics:
    """Plain PyTorch transcendentals (the no-technique baseline)."""

    name = "exact"
    library = None

    silu = staticmethod(F.silu)
    sigmoid = staticmethod(torch.sigmoid)
    softplus = staticmethod(F.softplus)
    tanh = staticmethod(torch.tanh)

    @staticmethod
    def gelu(x):
        # the reference's partial(jax.nn.gelu, approximate=True)
        return F.gelu(x, approximate="tanh")

    @staticmethod
    def softmax(x, axis: int = -1):
        return torch.softmax(x, dim=axis)  # keeps x's dtype, as jax.nn.softmax

    @staticmethod
    def exp_neg(x):
        return torch.exp(x)

    @staticmethod
    def rmsnorm(x, gamma, eps=1e-6):
        xf = x.to(_F32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True) + eps
        return (xf * torch.rsqrt(var) * gamma).to(x.dtype)

    @staticmethod
    def recip_pos(x):
        return 1.0 / x


class InterpNumerics:
    """The paper's technique as the model's numerics backend. Bound to a
    compiled :class:`repro_torch.api.InterpLibrary`, every table read goes
    through the library ROM; unbound (``library=None``, the
    ``get_numerics("interp")`` default) each op resolves its table lazily
    through ``get_table`` and reads it with :func:`table_eval_int`, and the
    activations quantize over the default window."""

    name = "interp"

    def __init__(self, library=None):
        self.library = library

    def _eval(self, kind: str):
        """The integer evaluator of ``kind``: int32 codes -> table output."""
        lib = self.library
        if lib is None:
            d = get_table(kind)
            return lambda c: table_eval_int(c, d)
        return lambda c: lib.eval_int(c, kind)

    def _ev(self, kind: str):
        """(in_bits, out_bits, int evaluator) for ``kind``."""
        lib = self.library
        m = get_table(kind) if lib is None else lib.meta(kind)
        return m.in_bits, m.out_bits, self._eval(kind)

    def exp_neg(self, x):
        ib, ob, ev = self._ev("exp2neg")
        return _exp_neg_glue(x, ib, ob, ev)

    def recip_pos(self, x):
        ib, _, ev = self._ev("recip")
        return _recip_pos_glue(x, ib, ev)

    def rsqrt_pos(self, x):
        ib, ob, ev = self._ev("rsqrt")
        return _rsqrt_pos_glue(x, ib, ob, ev)

    def _act(self, kind: str, x):
        if self.library is None:
            ib, ob, ev = self._ev(kind)
            return _act_tails(kind, x,
                              _range_glue(x, ib, ob, act_out_span(kind), ev))
        # the artifact records the window its table was generated over
        m = self.library.meta(kind)
        y = _range_glue(x, m.in_bits, m.out_bits, m.act_span,
                        self._eval(kind), m.act_lo, m.act_hi)
        return _act_tails(kind, x, y, m.act_lo, m.act_hi)

    def silu(self, x):
        return self._act("silu", x)

    def sigmoid(self, x):
        return self._act("sigmoid", x)

    def softplus(self, x):
        return self._act("softplus", x)

    def gelu(self, x):
        return self._act("gelu", x)

    def tanh(self, x):
        return self._act("tanh", x)

    def softmax(self, x, axis: int = -1):
        xf = x.to(_F32)
        m = torch.amax(xf, dim=axis, keepdim=True).detach()  # stop_gradient
        e = self.exp_neg(xf - m)
        s = torch.sum(e, dim=axis, keepdim=True)
        return (e * self.recip_pos(s)).to(x.dtype)

    def rmsnorm(self, x, gamma, eps: float = 1e-6):
        xf = x.to(_F32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True) + eps
        return (xf * self.rsqrt_pos(var) * gamma).to(x.dtype)


class FusedInterpNumerics(InterpNumerics):
    """Library-bound interp numerics lowered to the fused kernels: rmsnorm
    (``rmsnorm_lib``), the attention inner loop (``flash_attn_lib``), the
    last-axis softmax (``softmax_lib``) and the activations (``act_lib``:
    the float glue and the table read in one kernel) read the library ROM
    in-kernel.

    As in the reference, the fused rsqrt / recip glue derives table codes by
    IEEE-754 bit twiddles where the unfused glue uses ``frexp``; composite
    outputs may differ from :class:`InterpNumerics` by one table ulp, so
    fused runs are held against fused runs.
    """

    fused = True

    def __init__(self, library):
        if library is None:
            raise ValueError(
                "FusedInterpNumerics needs a compiled InterpLibrary: the "
                "fused kernels thread its ROM as an operand (compile one "
                "with Explorer.compile() or pass fused=False)")
        super().__init__(library)

    def softmax(self, x, axis: int = -1):
        if axis not in (-1, x.dim() - 1):
            return super().softmax(x, axis=axis)
        return self._softmax(x).to(x.dtype)

    def _softmax(self, x):
        from repro_torch.kernels.softmax.ops import approx_softmax_library

        return approx_softmax_library(x, self.library)

    def rmsnorm(self, x, gamma, eps: float = 1e-6):
        from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library

        return approx_rmsnorm_library(x, gamma, self.library, eps=eps
                                      ).to(x.dtype)

    def _act(self, kind: str, x):
        """One ``act_lib`` launch on a CUDA tensor (glue and table read in
        one kernel, bitwise the glue around ``eval_int``); its plain
        version on the CPU."""
        from repro_torch.kernels.interp.ops import act_library

        return act_library(x, self.library, kind)

    def _attention(self, q, k, v, **kw):
        from repro_torch.kernels.flashattn.ops import attention_fused_library

        return attention_fused_library(q, k, v, self.library, **kw)

    def fused_attention(self, q, k, v, q_pos, kv_pos, *, causal, window,
                        scale):
        """The ``attention_core`` fast path; None sends the caller to the
        chunked glue path (the reference's routing: Sk >
        ``FUSED_ATTN_MAX_KEYS`` always, and Sq * Sk >
        ``FUSED_ATTN_MAX_PAIRS`` where the plain version would form the
        whole score block, which here means on the CPU)."""
        h, kvh = q.shape[2], k.shape[2]
        if h % kvh:
            return None
        if k.shape[1] > FUSED_ATTN_MAX_KEYS:
            return None
        if q.shape[1] * k.shape[1] > FUSED_ATTN_MAX_PAIRS and not q.is_cuda:
            return None
        return self._attention(q, k, v, causal=causal, window=window,
                               scale=scale, q_pos=q_pos, kv_pos=kv_pos)


class PlainFusedNumerics(FusedInterpNumerics):
    """The fused datapath through the kernels' plain versions on any device
    (no kernel launches): the oracle that a card run compares the kernel
    path with."""

    def _eval(self, kind: str):
        """The plain version of the kernel ``eval_int`` launches: the walk
        (``library_walk_ref``) once any slot is segmented, as
        ``InterpLibrary.eval_fused`` routes; ``library_eval_ref`` would read
        leaf 0's datapath row for every element of a segmented slot."""
        from repro_torch.kernels.interp.ref import (library_eval_ref,
                                                    library_walk_ref)

        lib = self.library
        fid = lib.func_id(kind)

        def one(codes):
            fids = torch.full_like(codes, fid, dtype=torch.int32)
            if lib.segmented_kinds:
                return library_walk_ref(codes, fids, lib.coeffs,
                                        *lib.walk_rows())
            return library_eval_ref(codes, fids, lib.coeffs, lib.meta_rows())

        def ev(codes):
            # elementwise, so a large call reads its codes in slices: the
            # plain version's int64 temporaries are ~40 bytes an element
            if codes.numel() <= PLAIN_SLICE:
                return one(codes)
            return torch.cat([one(c) for c in codes.reshape(-1).split(
                PLAIN_SLICE)]).reshape(codes.shape)
        return ev

    # the glue around the plain table read on every device
    _act = InterpNumerics._act

    def fused_attention(self, q, k, v, q_pos, kv_pos, *, causal, window,
                        scale):
        """As the kernel path, but past ``FUSED_ATTN_MAX_PAIRS`` the chunked
        glue path on every device: the plain version forms the whole score
        block (the CPU routing of :class:`FusedInterpNumerics`)."""
        if q.shape[1] * k.shape[1] > FUSED_ATTN_MAX_PAIRS:
            return None
        return super().fused_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                       window=window, scale=scale)

    def _softmax(self, x):
        from repro_torch.kernels.softmax.ref import approx_softmax_library_ref

        return approx_softmax_library_ref(x, self.library)

    def rmsnorm(self, x, gamma, eps: float = 1e-6):
        from repro_torch.kernels.rmsnorm.ref import approx_rmsnorm_library_ref

        return approx_rmsnorm_library_ref(x, gamma, self.library, eps=eps
                                          ).to(x.dtype)

    def _attention(self, q, k, v, **kw):
        from repro_torch.kernels.flashattn.ref import \
            attention_fused_library_ref

        return attention_fused_library_ref(q, k, v, self.library, **kw)


BACKENDS = {"exact": ExactNumerics, "interp": InterpNumerics,
            "interp-fused": FusedInterpNumerics}

INTERP_BACKENDS = ("interp", "interp-fused", "interp-guarded")


def get_numerics(cfg_or_name="exact", library=None, fused: bool = False,
                 device=None):
    """A numerics backend instance for a model config (or backend name).
    ``library`` binds the interp backend to a compiled ``InterpLibrary``;
    without one, ``"interp"`` resolves each table through ``get_table``.
    ``fused=True`` or the ``"interp-fused"`` name selects the fused-kernel
    lowering, which needs a library. ``"interp-guarded"`` is the degraded
    backend: the unfused interp datapath behind the
    :class:`~repro_torch.numerics.guard.GuardedNumerics` domain clamp,
    which clamps silently (counting violations costs a host sync per op).

    A config carrying a :class:`repro_torch.plan.NumericsPlan` resolves to a
    :class:`repro_torch.plan.numerics.PlanNumerics`: per-layer x per-site
    backends; ``fused`` is then ignored (each site assignment names its own
    lowering) and ``library`` may be a dict keyed by plan slot. Without
    one, the slot libraries are compiled on ``device`` (default CUDA).
    """
    plan = getattr(cfg_or_name, "plan", None)
    if plan is not None:
        from repro_torch.plan.numerics import plan_numerics

        return plan_numerics(plan, libraries=library,
                             device=device if device is not None else "cuda")
    name = getattr(cfg_or_name, "numerics", cfg_or_name)
    if name == "exact":
        return ExactNumerics()
    if name == "interp-guarded":
        from repro_torch.numerics.guard import GuardedNumerics

        return GuardedNumerics(InterpNumerics(library))
    if name == "interp-fused" or (name == "interp" and fused):
        return FusedInterpNumerics(library)
    if name == "interp":
        return InterpNumerics(library)
    raise KeyError(f"unknown numerics backend {name!r}")


def softmax_ulp_bound(exp_design=None, recip_design=None) -> float:
    """Certified relative error bound of table-softmax terms from the
    tables' widths (``TableDesign``, ``FuncMeta`` or ``SegmentedDesign``;
    ``None`` resolves through the default session): the twin of the
    reference's bound, used to state attention tolerances. It reads only
    in_bits and out_bits, so it holds for segmented exp2neg / recip slots
    too: a segmented design meets the same faithful-rounding certificate at
    every code."""
    exp_design = _tab("exp2neg", exp_design)
    recip_design = _tab("recip", recip_design)
    exp_rel = ((2.0 ** -exp_design.out_bits) * 2
               + math.log(2.0) * 2.0 ** -(exp_design.in_bits + 1))
    recip_rel = 2.0 ** -recip_design.in_bits
    return 2 * exp_rel + 2 * recip_rel
