"""Interpolation table artifact (twin of ``repro/core/table.py``).

A ``TableDesign`` is one certified piecewise-polynomial table: a coefficient
ROM (one (a, b, c) row per region) plus the static datapath parameters. The
integer evaluation here is the exact int64 oracle every other path is held
against.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass
class CoeffMeta:
    """Storage format of one coefficient column."""

    bits: int
    shift: int
    signed: bool


@dataclasses.dataclass
class TableDesign:
    """A concrete, verified piecewise-polynomial implementation."""

    name: str
    in_bits: int
    out_bits: int
    lookup_bits: int  # R
    k: int
    degree: int  # 1 (linear) or 2 (quadratic)
    sq_trunc: int  # low bits of x zeroed before squaring
    lin_trunc: int  # low bits of x zeroed in the linear term
    a: np.ndarray  # (2^R,) int64
    b: np.ndarray
    c: np.ndarray
    a_meta: CoeffMeta
    b_meta: CoeffMeta
    c_meta: CoeffMeta

    @property
    def eval_bits(self) -> int:  # W
        return self.in_bits - self.lookup_bits

    def eval_int(self, codes: np.ndarray) -> np.ndarray:
        """Exact integer evaluation: floor((a*sq(x) + b*lin(x) + c) / 2^k)
        in int64 (arithmetic right shift == floor division)."""
        codes = np.asarray(codes, dtype=np.int64)
        w = self.eval_bits
        r = codes >> w
        x = codes & ((1 << w) - 1)
        xs = (x >> self.sq_trunc) << self.sq_trunc
        xl = (x >> self.lin_trunc) << self.lin_trunc
        acc = self.a[r] * xs * xs + self.b[r] * xl + self.c[r]
        return acc >> self.k

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
        """Whether every coefficient fits the kernels' int32 ROM."""
        mat = np.stack([self.a, self.b, self.c], axis=1)
        return bool(np.abs(mat).max() < 2**31)

    def packed_coeffs(self) -> np.ndarray:
        """(2^R, 3) int32 coefficient matrix for the kernels; raises if a
        coefficient exceeds int32."""
        if not self.fits_int32:
            raise ValueError(f"{self.name}: coefficients exceed int32")
        return np.stack([self.a, self.b, self.c], axis=1).astype(np.int32)
