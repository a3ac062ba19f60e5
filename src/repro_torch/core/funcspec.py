"""Function specifications: fixed-point targets with integer bound functions
(twin of ``repro/core/funcspec.py``).

The paper specifies a target only through integer upper/lower bound functions
``u, l`` over the input codes (§II): any implementation whose integer output
lands in ``[l(Z), u(Z)]`` for every code ``Z`` is correct. This module builds
those bound arrays for the paper's three functions (reciprocal, log2, exp2)
and for the ML-numerics functions used by the transformer stack (exp2 of a
negative fraction for softmax, rsqrt for RMSNorm, sigmoid/SiLU, softplus).

Exactness: reciprocal bounds are computed in exact integer arithmetic; the
transcendental ones use float64 (as the paper used Python's math library) and
every generated table is later re-verified exhaustively in int64, so a float
edge case can only cost a retry, never an unsound artifact (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

# Input window of the direct activation tables (silu / sigmoid / softplus /
# gelu / tanh): codes map affinely onto [ACT_LO, ACT_HI). The float glue in
# ``repro_torch.numerics`` and the library metadata in
# ``repro_torch.api.library`` both read these — the window lives here, next
# to the bound makers, and nowhere else.
ACT_LO, ACT_HI = -8.0, 8.0
ACT_KINDS = ("silu", "sigmoid", "softplus", "gelu", "tanh")


def act_out_span(kind: str, lo: float = ACT_LO, hi: float = ACT_HI) -> float:
    """Output span S of a direct activation table: the stored integer is
    ``value * 2^out_bits / S``, so the float glue rescales by
    ``S / 2^out_bits``. sigmoid's range is (0, 1), tanh's (-1, 1); the
    others scale by the input window width so the signed/linear tails stay
    representable."""
    if kind not in ACT_KINDS:
        raise KeyError(f"{kind!r} is not a direct activation table")
    if kind == "sigmoid":
        return 1.0
    if kind == "tanh":
        return 2.0
    return hi - lo


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """A fixed-point approximation target.

    Attributes:
      name: identifier, e.g. ``recip16``.
      in_bits: input code width; codes run over ``[0, 2^in_bits)``.
      out_bits: nominal output width (bits of the produced integer; used for
        reporting and the area model — bounds carry the real constraint).
      bounds: callable mapping an int64 code array to ``(L, U)`` int64 arrays.
      value: callable mapping codes to the real-valued target on the output
        integer grid (for plotting/Remez); may be None for bound-only specs.
      ulp: the accuracy budget in output ULPs used to build default bounds.
      signed_output: whether outputs may be negative (SiLU).
    """

    name: str
    in_bits: int
    out_bits: int
    bounds: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]
    value: Callable[[np.ndarray], np.ndarray] | None = None
    ulp: float = 1.0
    signed_output: bool = False

    def bound_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        codes = np.arange(1 << self.in_bits, dtype=np.int64)
        lo, hi = self.bounds(codes)
        if np.any(lo > hi):
            raise ValueError(f"{self.name}: empty bound interval")
        return lo.astype(np.int64), hi.astype(np.int64)

    def region_bounds(self, lookup_bits: int) -> tuple[np.ndarray, np.ndarray]:
        """(L, U) reshaped to (2^R, 2^W): one row per region r."""
        lo, hi = self.bound_arrays()
        r = 1 << lookup_bits
        return lo.reshape(r, -1), hi.reshape(r, -1)


def _float_bounds(values: np.ndarray, ulp: float) -> tuple[np.ndarray, np.ndarray]:
    """Default ±ulp bounds around real-valued targets on the integer grid."""
    lo = np.ceil(values - ulp).astype(np.int64)
    hi = np.floor(values + ulp).astype(np.int64)
    return lo, hi


def make_reciprocal(bits: int, ulp: float = 1.0) -> FunctionSpec:
    """``0.1y = 1 / 1.x`` (paper Table I), exact integer bounds.

    Input code Z: X = 1 + Z/2^bits in [1, 2).  Output integer targets
    V = 2^(2*bits+1) / (2^bits + Z), spanning (2^bits, 2^(bits+1)].
    """
    num = 1 << (2 * bits + 1)

    def bounds(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        # V = num/den; |Y - V| <= ulp with exact rational comparisons.
        # ceil(num/den - ulp) and floor(num/den + ulp) for rational ulp.
        u_num, u_den = _as_fraction(ulp)
        den64 = (1 << bits) + codes.astype(np.int64)
        d_max = int(den64.max()) if len(den64) else 1
        if num * u_den + u_num * d_max < (1 << 62):
            # every intermediate fits int64: numpy floor division is exact
            # and rounds toward -inf exactly like python's // on negatives
            lo = -((-(num * u_den - u_num * den64)) // (den64 * u_den))
            hi = (num * u_den + u_num * den64) // (den64 * u_den)
            return lo, hi
        den = (1 << bits) + codes.astype(object)  # exact python ints
        lo = [-((-(num * u_den - u_num * int(d))) // (int(d) * u_den)) for d in den]
        hi = [(num * u_den + u_num * int(d)) // (int(d) * u_den) for d in den]
        return np.array(lo, dtype=np.int64), np.array(hi, dtype=np.int64)

    def value(codes: np.ndarray) -> np.ndarray:
        return num / ((1 << bits) + codes.astype(np.float64))

    return FunctionSpec(f"recip{bits}", bits, bits + 1, bounds, value, ulp)


def _as_fraction(x: float) -> tuple[int, int]:
    from fractions import Fraction

    f = Fraction(x).limit_denominator(1 << 20)
    return f.numerator, f.denominator


def make_log2(bits: int, out_bits: int | None = None, ulp: float = 1.0) -> FunctionSpec:
    """``0.y = log2(1.x)`` (paper Table I: 16 -> 17)."""
    out_bits = out_bits if out_bits is not None else bits + 1

    def value(codes: np.ndarray) -> np.ndarray:
        x = 1.0 + codes.astype(np.float64) / (1 << bits)
        return np.log2(x) * (1 << out_bits)

    return FunctionSpec(
        f"log2_{bits}", bits, out_bits, lambda c: _float_bounds(value(c), ulp), value, ulp
    )


def make_exp2(bits: int, out_bits: int | None = None, ulp: float = 1.0) -> FunctionSpec:
    """``1.y = 2^(0.x)`` (paper Table I)."""
    out_bits = out_bits if out_bits is not None else bits

    def value(codes: np.ndarray) -> np.ndarray:
        x = codes.astype(np.float64) / (1 << bits)
        return np.exp2(x) * (1 << out_bits)

    return FunctionSpec(
        f"exp2_{bits}", bits, out_bits + 1, lambda c: _float_bounds(value(c), ulp), value, ulp
    )


def make_exp2neg(bits: int, out_bits: int | None = None, ulp: float = 1.0) -> FunctionSpec:
    """``y = 2^(-0.x)`` in (1/2, 1] — the softmax exponential's fraction part."""
    out_bits = out_bits if out_bits is not None else bits

    def value(codes: np.ndarray) -> np.ndarray:
        x = codes.astype(np.float64) / (1 << bits)
        return np.exp2(-x) * (1 << out_bits)

    return FunctionSpec(
        f"exp2neg_{bits}", bits, out_bits, lambda c: _float_bounds(value(c), ulp), value, ulp
    )


def make_rsqrt(bits: int, out_bits: int | None = None, ulp: float = 1.0) -> FunctionSpec:
    """``y = 1/sqrt(1.x or 1x.x)`` over X in [1, 4) — RMSNorm normalizer.

    Input code covers [1,4): X = 1 + 3*Z/2^bits is NOT hardware-friendly;
    instead use two implicit-exponent segments: X = 2^(Z_top) * (1 + frac)
    with the top input bit selecting [1,2) vs [2,4).
    """
    out_bits = out_bits if out_bits is not None else bits

    def value(codes: np.ndarray) -> np.ndarray:
        z = codes.astype(np.float64)
        seg = np.floor(z / (1 << (bits - 1)))  # 0 -> [1,2), 1 -> [2,4)
        frac = (z - seg * (1 << (bits - 1))) / (1 << (bits - 1))
        x = (1.0 + frac) * (2.0**seg)
        return (1 << out_bits) / np.sqrt(x)

    return FunctionSpec(
        f"rsqrt{bits}", bits, out_bits, lambda c: _float_bounds(value(c), ulp), value, ulp
    )


def make_sigmoid(bits: int, out_bits: int | None = None, lo: float = ACT_LO, hi: float = ACT_HI,
                 ulp: float = 1.0) -> FunctionSpec:
    """``y = sigmoid(s)``, s affinely mapped from codes over [lo, hi)."""
    out_bits = out_bits if out_bits is not None else bits

    def value(codes: np.ndarray) -> np.ndarray:
        s = lo + (hi - lo) * codes.astype(np.float64) / (1 << bits)
        return (1 << out_bits) / (1.0 + np.exp(-s))

    return FunctionSpec(
        f"sigmoid{bits}", bits, out_bits, lambda c: _float_bounds(value(c), ulp), value, ulp
    )


def make_silu(bits: int, out_bits: int | None = None, lo: float = ACT_LO, hi: float = ACT_HI,
              ulp: float = 1.0) -> FunctionSpec:
    """``y = s * sigmoid(s)`` — signed output (min ~= -0.278 * scale / range)."""
    out_bits = out_bits if out_bits is not None else bits

    def value(codes: np.ndarray) -> np.ndarray:
        s = lo + (hi - lo) * codes.astype(np.float64) / (1 << bits)
        return s / (1.0 + np.exp(-s)) * (1 << out_bits) / (hi - lo)

    return FunctionSpec(
        f"silu{bits}", bits, out_bits, lambda c: _float_bounds(value(c), ulp), value, ulp,
        signed_output=True,
    )


def make_softplus(bits: int, out_bits: int | None = None, lo: float = ACT_LO, hi: float = ACT_HI,
                  ulp: float = 1.0) -> FunctionSpec:
    """``y = log(1 + e^s)`` — Mamba2's dt activation."""
    out_bits = out_bits if out_bits is not None else bits

    def value(codes: np.ndarray) -> np.ndarray:
        s = lo + (hi - lo) * codes.astype(np.float64) / (1 << bits)
        return np.logaddexp(0.0, s) * (1 << out_bits) / (hi - lo)

    return FunctionSpec(
        f"softplus{bits}", bits, out_bits, lambda c: _float_bounds(value(c), ulp), value, ulp
    )


def make_gelu(bits: int, out_bits: int | None = None, lo: float = ACT_LO, hi: float = ACT_HI,
              ulp: float = 1.0) -> FunctionSpec:
    """tanh-form GELU (Whisper/ViT MLPs) — signed output."""
    out_bits = out_bits if out_bits is not None else bits

    def value(codes: np.ndarray) -> np.ndarray:
        s = lo + (hi - lo) * codes.astype(np.float64) / (1 << bits)
        inner = np.sqrt(2.0 / np.pi) * (s + 0.044715 * s**3)
        return 0.5 * s * (1.0 + np.tanh(inner)) * (1 << out_bits) / (hi - lo)

    return FunctionSpec(
        f"gelu{bits}", bits, out_bits, lambda c: _float_bounds(value(c), ulp), value, ulp,
        signed_output=True,
    )


def make_tanh(bits: int, out_bits: int | None = None, lo: float = ACT_LO, hi: float = ACT_HI,
              ulp: float = 1.0) -> FunctionSpec:
    """``y = tanh(s)`` — signed output in (-1, 1), span 2 (Jamba/Mamba gates,
    classic RNN cells; the VLSI segmentation literature's canonical case)."""
    out_bits = out_bits if out_bits is not None else bits

    def value(codes: np.ndarray) -> np.ndarray:
        s = lo + (hi - lo) * codes.astype(np.float64) / (1 << bits)
        return np.tanh(s) * (1 << out_bits) / 2.0

    return FunctionSpec(
        f"tanh{bits}", bits, out_bits, lambda c: _float_bounds(value(c), ulp), value, ulp,
        signed_output=True,
    )


MAKERS: dict[str, Callable[..., FunctionSpec]] = {
    "tanh": make_tanh,
    "recip": make_reciprocal,
    "log2": make_log2,
    "exp2": make_exp2,
    "exp2neg": make_exp2neg,
    "rsqrt": make_rsqrt,
    "sigmoid": make_sigmoid,
    "silu": make_silu,
    "softplus": make_softplus,
    "gelu": make_gelu,
}


def get_spec(kind: str, bits: int, **kw) -> FunctionSpec:
    return MAKERS[kind](bits, **kw)
