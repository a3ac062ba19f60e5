"""Minimax (Remez-exchange) baseline — the FloPoCo/Sollya stand-in (twin
of ``repro/core/remez.py``, numpy, the same designs bit for bit).

The paper compares its complete-space tables against FloPoCo, whose
polynomials come from Sollya's modified Remez algorithm (paper refs [8-11]).
FloPoCo is not installable here, so we implement the same *method*: per
region, a discrete Remez exchange computes the real minimax polynomial of the
target values; coefficients are then rounded to finite precision at the
smallest k that still meets the bound spec, with the constant re-centred
exactly after rounding (the standard trick). Table II's comparison (Remez
needs wider `a`) is reproduced against this baseline.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.fixedpoint import bit_length_of
from repro_torch.core.funcspec import FunctionSpec
from repro_torch.core.table import CoeffMeta, TableDesign


def remez_fit(xs: np.ndarray, vals: np.ndarray, degree: int,
              iters: int = 60) -> np.ndarray:
    """Discrete minimax polynomial coefficients (low-to-high) on grid xs."""
    n = len(xs)
    if n <= degree + 1:
        return _exact_fit(xs, vals, degree)
    # initial reference: Chebyshev-spaced indices
    ref = np.unique(np.round(
        (n - 1) * (0.5 - 0.5 * np.cos(np.pi * np.arange(degree + 2) / (degree + 1)))
    ).astype(int))
    while len(ref) < degree + 2:
        pool = np.setdiff1d(np.arange(n), ref)
        ref = np.sort(np.append(ref, pool[0]))
    coeffs = np.zeros(degree + 1)
    for _ in range(iters):
        # solve p(x_i) + (-1)^i E = v_i on the reference
        a_mat = np.vander(xs[ref], degree + 1, increasing=True)
        sys = np.hstack([a_mat, ((-1.0) ** np.arange(len(ref)))[:, None]])
        sol, *_ = np.linalg.lstsq(sys, vals[ref], rcond=None)
        coeffs = sol[:-1]
        err = np.polyval(coeffs[::-1], xs) - vals
        worst = int(np.argmax(np.abs(err)))
        if worst in ref:
            break
        # single-point exchange preserving sign alternation
        new_ref = ref.copy()
        pos = np.searchsorted(ref, worst)
        if pos == 0:
            new_ref[0] = worst if np.sign(err[worst]) == np.sign(err[ref[0]]) else new_ref[0]
            if np.sign(err[worst]) != np.sign(err[ref[0]]):
                new_ref = np.sort(np.append(ref[:-1], worst))
        elif pos >= len(ref):
            if np.sign(err[worst]) == np.sign(err[ref[-1]]):
                new_ref[-1] = worst
            else:
                new_ref = np.sort(np.append(ref[1:], worst))
        else:
            side = pos if np.sign(err[worst]) == np.sign(err[ref[pos]]) else pos - 1
            new_ref[side] = worst
        new_ref = np.unique(new_ref)
        if len(new_ref) < degree + 2 or np.array_equal(new_ref, ref):
            break
        ref = new_ref
    return coeffs


def _exact_fit(xs: np.ndarray, vals: np.ndarray, degree: int) -> np.ndarray:
    c = np.polyfit(xs, vals, min(degree, len(xs) - 1))[::-1]
    return np.pad(c, (0, degree + 1 - len(c)))


@dataclasses.dataclass
class RemezResult:
    design: TableDesign
    k: int
    widths: tuple[int, int, int]


def generate_remez_table(spec: FunctionSpec, lookup_bits: int, degree: int = 2,
                         k_max: int = 30) -> RemezResult | None:
    """Round-and-verify loop: smallest k whose rounded minimax coefficients
    satisfy the integer bound spec in every region (c re-centred exactly)."""
    lo_all, hi_all = spec.region_bounds(lookup_bits)
    n_regions, n = lo_all.shape
    xs = np.arange(n, dtype=np.float64)
    x_int = np.arange(n, dtype=np.int64)
    # real minimax fit of the bound midpoints per region
    fits = np.zeros((n_regions, degree + 1))
    mids = (lo_all + hi_all).astype(np.float64) / 2.0
    for r in range(n_regions):
        fits[r] = (remez_fit(xs, mids[r], degree) if n > 1
                   else np.array([mids[r][0]] + [0.0] * degree))

    for k in range(k_max + 1):
        scale = float(1 << k)
        av = np.round(fits[:, 2] * scale).astype(np.int64) if degree == 2 else np.zeros(n_regions, np.int64)
        bv = np.round(fits[:, 1] * scale).astype(np.int64)
        cv = np.zeros(n_regions, dtype=np.int64)
        ok = True
        for r in range(n_regions):
            poly = av[r] * x_int * x_int + bv[r] * x_int
            c_lo = int(((lo_all[r].astype(np.int64) << k) - poly).max())
            c_hi = int((((hi_all[r].astype(np.int64) + 1) << k) - poly).min()) - 1
            if c_lo > c_hi:
                ok = False
                break
            cv[r] = (c_lo + c_hi) // 2  # exact re-centring
        if not ok:
            continue

        def meta(vals: np.ndarray) -> CoeffMeta:
            signed = bool((vals < 0).any())
            mags = np.abs(vals)
            return CoeffMeta(bits=max(bit_length_of(int(mags.max())), 1) if mags.max() else 0,
                             shift=0, signed=signed)

        design = TableDesign(
            name=f"{spec.name}_remez_R{lookup_bits}", in_bits=spec.in_bits,
            out_bits=spec.out_bits, lookup_bits=lookup_bits, k=k, degree=degree,
            sq_trunc=0, lin_trunc=0, a=av, b=bv, c=cv,
            a_meta=meta(av), b_meta=meta(bv), c_meta=meta(cv),
        )
        valid, _ = design.verify(spec)
        if valid:
            return RemezResult(design=design, k=k, widths=design.lut_widths)
    return None
