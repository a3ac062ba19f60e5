"""Interpolation table artifact + exhaustive bit-exact verification (twin of
``repro/core/table.py``).

A ``TableDesign`` is the framework's equivalent of the paper's generated RTL:
a coefficient ROM (one (a, b, c) row per region) plus the static datapath
parameters (k, square/linear input truncations, coefficient widths/shifts).
``verify`` replaces the paper's HECTOR formal check with an exhaustive int64
sweep over every input code — exact, and feasible at the widths we target.
The integer evaluation here is the exact int64 oracle every other path is
held against.

The reference's device arrays become torch tensors on an explicit device:
``device_coeffs`` (int32, the kernels' operand) and ``device_coeffs_wide``
(native int64, the operand of the wide path; the reference needs a
two-word emulation only because its jax runs with x64 off).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from repro_torch.core.funcspec import FunctionSpec


@dataclasses.dataclass
class CoeffMeta:
    """Storage format of one coefficient column (Algorithm 1 output)."""

    bits: int  # stored magnitude bits P
    shift: int  # trailing zeros truncated from storage
    signed: bool  # whether a sign bit is stored

    @property
    def width(self) -> int:  # LUT column width as reported in Table II
        return self.bits + (1 if self.signed else 0)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TableDesign:
    """A concrete, verified piecewise-polynomial implementation."""

    name: str
    in_bits: int
    out_bits: int
    lookup_bits: int  # R
    k: int
    degree: int  # 1 (linear) or 2 (quadratic)
    sq_trunc: int  # i: low bits of x zeroed before squaring
    lin_trunc: int  # j: low bits of x zeroed in the linear term
    a: np.ndarray  # (2^R,) int64
    b: np.ndarray
    c: np.ndarray
    a_meta: CoeffMeta
    b_meta: CoeffMeta
    c_meta: CoeffMeta
    # lazily-populated device tensors keyed by (kind, device) (see
    # device_coeffs); excluded from serialization and never part of design
    # identity
    _device_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def eval_bits(self) -> int:  # W
        return self.in_bits - self.lookup_bits

    @property
    def lut_widths(self) -> tuple[int, int, int]:
        return (self.a_meta.width, self.b_meta.width, self.c_meta.width)

    @property
    def lut_total_width(self) -> int:
        return sum(self.lut_widths)

    def eval_int(self, codes: np.ndarray) -> np.ndarray:
        """Exact integer evaluation: floor((a*sq(x) + b*lin(x) + c) / 2^k).

        Arithmetic right shift on signed int64 == floor division by 2^k,
        matching the paper's floor semantics.
        """
        codes = np.asarray(codes, dtype=np.int64)
        w = self.eval_bits
        r = codes >> w
        x = codes & ((1 << w) - 1)
        xs = (x >> self.sq_trunc) << self.sq_trunc
        xl = (x >> self.lin_trunc) << self.lin_trunc
        acc = self.a[r] * xs * xs + self.b[r] * xl + self.c[r]
        return acc >> self.k

    def verify(self, spec: FunctionSpec) -> tuple[bool, int]:
        """Exhaustive check: every input's output inside [L, U].

        Returns (ok, worst signed violation in output ULPs; 0 when ok).
        """
        lo, hi = spec.bound_arrays()
        codes = np.arange(1 << self.in_bits, dtype=np.int64)
        y = self.eval_int(codes)
        under = lo - y
        over = y - hi
        worst = int(max(under.max(), over.max()))
        return worst <= 0, max(worst, 0)

    def max_error_ulp(self, spec: FunctionSpec) -> float:
        """Max |y - value| in output ULPs against the real-valued target."""
        if spec.value is None:
            raise ValueError("spec has no real-valued target")
        codes = np.arange(1 << self.in_bits, dtype=np.int64)
        y = self.eval_int(codes).astype(np.float64)
        return float(np.abs(y - spec.value(codes)).max())

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "in_bits": self.in_bits,
            "out_bits": self.out_bits,
            "lookup_bits": self.lookup_bits,
            "k": self.k,
            "degree": self.degree,
            "sq_trunc": self.sq_trunc,
            "lin_trunc": self.lin_trunc,
            "a": self.a.tolist(),
            "b": self.b.tolist(),
            "c": self.c.tolist(),
            "a_meta": self.a_meta.to_dict(),
            "b_meta": self.b_meta.to_dict(),
            "c_meta": self.c_meta.to_dict(),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TableDesign":
        return cls(
            name=d["name"], in_bits=d["in_bits"], out_bits=d["out_bits"],
            lookup_bits=d["lookup_bits"], k=d["k"], degree=d["degree"],
            sq_trunc=d["sq_trunc"], lin_trunc=d["lin_trunc"],
            a=np.array(d["a"], dtype=np.int64),
            b=np.array(d["b"], dtype=np.int64),
            c=np.array(d["c"], dtype=np.int64),
            a_meta=CoeffMeta(**d["a_meta"]),
            b_meta=CoeffMeta(**d["b_meta"]),
            c_meta=CoeffMeta(**d["c_meta"]),
        )

    @property
    def fits_int32(self) -> bool:
        """Whether every coefficient fits the kernels' int32 ROM. Designs
        that don't (e.g. wide-output reciprocals) evaluate on the int64
        wide path (DESIGN.md §7.5, ``interp_eval_wide``)."""
        fits = self._device_cache.get("fits")
        if fits is None:
            mat = np.stack([self.a, self.b, self.c], axis=1)
            fits = bool(np.abs(mat).max() < 2**31)
            self._device_cache["fits"] = fits
        return fits

    def packed_coeffs(self) -> np.ndarray:
        """(2^R, 3) int32 coefficient matrix for the kernels; raises if any
        coefficient exceeds int32 — such tables (e.g. the 23-bit
        reciprocal's 37-bit c) evaluate on the int64 wide path instead
        (DESIGN.md §7.5)."""
        if not self.fits_int32:
            raise ValueError(f"{self.name}: coefficients exceed int32")
        return np.stack([self.a, self.b, self.c], axis=1).astype(np.int32)

    def device_coeffs(self, device="cuda"):
        """Cached (2^R, 3) int32 coefficient tensor on ``device`` (the
        ``interp_eval`` kernel's operand); raises if a coefficient exceeds
        int32."""
        return self._cached_tensor("coeffs", device, self.packed_coeffs)

    def device_coeffs_wide(self, device="cuda"):
        """Cached (2^R, 3) int64 coefficient tensor on ``device`` — the
        operand of ``interp_eval_wide``, the exact evaluation path for
        designs whose coefficients exceed int32."""
        return self._cached_tensor(
            "wide", device, lambda: np.stack([self.a, self.b, self.c], axis=1))

    def _cached_tensor(self, kind: str, device, host_fn):
        import torch

        from repro_torch.device import resolve

        dev = resolve(device)
        key = (kind, str(dev))
        t = self._device_cache.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(host_fn())).to(dev)
            self._device_cache[key] = t
        return t
