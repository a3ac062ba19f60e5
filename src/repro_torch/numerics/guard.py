"""GuardedNumerics: the degraded-mode wrapper around a numerics backend
(twin of ``repro/numerics/guard.py``).

The certified tables only promise anything inside their proved input
domains: ``exp2neg`` over non-positive exponents, ``recip`` / ``rsqrt``
over strictly positive operands, the activation tables over the generated
``[act_lo, act_hi)`` window (outside which the float glue's tails take
over). A poisoned activation (NaN from an upstream overflow, an Inf from a
bad prompt embedding, a negative variance from corrupted state) feeds
those lookups values with no certified meaning: ``frexp`` of a
non-positive operand yields garbage codes that read arbitrary ROM rows.

:class:`GuardedNumerics` wraps any backend and sanitizes every table input
into its certified domain first:

* non-finite values are replaced by the nearest domain sentinel (NaN ->
  the domain's safe center, +Inf / -Inf -> the domain edges), so a
  poisoned element degrades to a bounded wrong answer instead of
  NaN-flooding the whole tick;
* out-of-domain finite values are clamped to the domain edge; for the
  activation kinds this is the tail semantics the unguarded glue already
  applies, so guarding is a no-op on healthy inputs.

Counting violations per op (``self.violations``) needs the count on the
host: one device-to-host sync per op. So it is opt-in (``count=True``),
and ``strict=True`` (raise :class:`DomainViolation` instead of clamping)
implies it. The reference counts whenever it runs eagerly and clamps
silently under a trace; the engine's guarded rung here clamps silently,
as the reference's jitted serial rung does.
"""
from __future__ import annotations

import torch

_F32 = torch.float32

# float32 extremes of the positive domains: below / above these, recip and
# rsqrt glue saturates rather than feeding frexp a non-positive operand.
# The floor is the smallest normal float32 (the reference's XLA compares
# flush subnormals to zero, and subnormals overflow the glue's
# power-of-two rescale).
_POS_TINY = 1.1754944e-38  # 2**-126
_POS_HUGE = 3e38
_EXP_NEG_FLOOR = -126.0  # exp2 underflows to 0 below this anyway


class DomainViolation(RuntimeError):
    """A table input left its certified domain under ``strict=True``."""


class GuardedNumerics:
    """Domain-guarding wrapper; delegates everything else to ``inner``."""

    def __init__(self, inner, *, strict: bool = False, count: bool = False):
        self.inner = inner
        self.strict = bool(strict)
        self.count = bool(count) or self.strict
        self.violations: dict[str, int] = {}

    # the engine and model stack probe these on whatever backend they hold
    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def library(self):
        return self.inner.library

    def __getattr__(self, attr):
        # unguarded capabilities pass through; the guard only interposes on
        # the table-input entry points below
        return getattr(self.inner, attr)

    # -- sanitization core -------------------------------------------------
    def _tally(self, op: str, bad: torch.Tensor, what: str) -> None:
        """Count ``bad`` elements under ``op`` (one host sync), raising in
        strict mode; nothing without ``count``."""
        if not self.count:
            return
        n = int(bad.sum())
        if n:
            self.violations[op] = self.violations.get(op, 0) + n
            if self.strict:
                raise DomainViolation(f"{op}: {n} {what}")

    def _guard(self, op: str, x, lo: float, hi: float, nan_to: float):
        xf = x if torch.is_tensor(x) else torch.as_tensor(x, dtype=_F32)
        xf32 = xf.to(_F32)
        bad = ~torch.isfinite(xf32) | (xf32 < lo) | (xf32 > hi)
        self._tally(op, bad, f"input(s) outside certified domain "
                             f"[{lo}, {hi}] (or non-finite)")
        clean = torch.clamp(torch.nan_to_num(xf32, nan=nan_to, posinf=hi,
                                             neginf=lo), lo, hi)
        return torch.where(bad, clean, xf32).to(xf.dtype)

    def _act_window(self, kind: str) -> tuple[float, float]:
        lib = self.library
        if lib is not None and kind in lib:
            m = lib.meta(kind)
            return m.act_lo, m.act_hi
        from repro_torch.core.funcspec import ACT_HI, ACT_LO

        return ACT_LO, ACT_HI

    # -- guarded table entry points ---------------------------------------
    def exp_neg(self, x):
        return self.inner.exp_neg(self._guard(
            "exp_neg", x, _EXP_NEG_FLOOR, 0.0, nan_to=_EXP_NEG_FLOOR))

    def recip_pos(self, x):
        return self.inner.recip_pos(
            self._guard("recip_pos", x, _POS_TINY, _POS_HUGE, nan_to=1.0))

    def rsqrt_pos(self, x):
        return self.inner.rsqrt_pos(
            self._guard("rsqrt_pos", x, _POS_TINY, _POS_HUGE, nan_to=1.0))

    def _act(self, kind: str, x):
        lo, hi = self._act_window(kind)
        # finite out-of-window inputs are the tails' job (certified glue);
        # the guard only repairs non-finite poison, mapping it to the same
        # saturation the tails produce at the window edges
        xf = x.to(_F32)
        bad = ~torch.isfinite(xf)
        self._tally(kind, bad, "non-finite input(s)")
        clean = torch.nan_to_num(xf, nan=0.0, posinf=hi, neginf=lo)
        y = getattr(self.inner, kind)(torch.where(bad, clean, xf))
        return y.to(x.dtype)

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

    # -- guarded composites ------------------------------------------------
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

    def total_violations(self) -> int:
        return sum(self.violations.values())
