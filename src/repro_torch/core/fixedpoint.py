"""Fixed-point format helpers (paper §II notation).

A format ``n.m`` has ``n`` integer bits and ``m`` fractional bits; an unsigned
integer code ``Z`` in ``[0, 2^(n+m))`` represents the real value ``Z * 2^-m``
(plus any affine range mapping owned by the function spec, e.g. the implicit
leading ``1.`` of the paper's ``1/1.x`` reciprocal).

Twin of ``repro/core/fixedpoint.py``.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FixedFormat:
    """An ``n.m`` unsigned fixed-point format."""

    n: int  # integer bits
    m: int  # fractional bits

    @property
    def bits(self) -> int:
        return self.n + self.m

    @property
    def count(self) -> int:
        return 1 << self.bits

    @property
    def scale(self) -> int:
        """Grid denominator: value = code / scale."""
        return 1 << self.m

    def to_real(self, code: int) -> float:
        return code / self.scale

    def __str__(self) -> str:  # "n.m"
        return f"{self.n}.{self.m}"


def split_input(z: int, total_bits: int, lookup_bits: int) -> tuple[int, int]:
    """Split code ``z`` into (r, x): top ``R`` lookup bits and low ``W`` bits."""
    w = total_bits - lookup_bits
    return z >> w, z & ((1 << w) - 1)


def join_input(r: int, x: int, total_bits: int, lookup_bits: int) -> int:
    w = total_bits - lookup_bits
    return (r << w) | x


def bit_length_of(value: int) -> int:
    """Bits needed for unsigned ``value`` (paper: ceil(log2(s+1)))."""
    return max(int(value).bit_length(), 1) if value >= 0 else int(-value).bit_length() + 1


def ceil_log2(x: int) -> int:
    return max(math.ceil(math.log2(x)), 0) if x > 1 else 0


def trailing_zeros(s: int) -> int:
    """max_i ((s >> i) << i == s) — trailing zero count; tz(0) = large."""
    if s == 0:
        return 63
    s = abs(int(s))
    return (s & -s).bit_length() - 1


def interval_trailing_zeros(lo: int, hi: int) -> int:
    """Largest t such that some multiple of 2^t lies in [lo, hi] (integers).

    Interval-analytic counterpart of Algorithm 1's per-element trailing-zero
    maximum: ``max_{s in [lo,hi]} tz(s)`` for non-negative intervals.
    """
    if lo > hi:
        raise ValueError("empty interval")
    if lo <= 0 <= hi:
        return 63  # zero has unbounded trailing zeros
    if hi < 0:
        lo, hi = -hi, -lo
    t = 0
    while True:
        step = 1 << (t + 1)
        if ((lo + step - 1) // step) * step > hi:
            return t
        t += 1
        if t >= 62:
            return 62


def min_bits_in_interval(lo: int, hi: int, t: int) -> int | None:
    """Min of ceil(log2(s+1)) - t over multiples s of 2^t in [lo, hi], |s| form.

    Works on non-negative intervals (callers split signs). Returns None if no
    multiple of 2^t is in range.
    """
    if lo > hi:
        return None
    step = 1 << t
    s = ((max(lo, 0) + step - 1) // step) * step
    if s > hi:
        return None
    # smallest magnitude multiple minimizes the bit count
    return max(bit_length_of(s) - t, 0) if s > 0 else 0
