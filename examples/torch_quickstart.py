"""Quickstart on the PyTorch port: the paper's pipeline end to end on one
function (twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--bits 12] [--kind recip] [--device cuda]

1. Open an ``Explorer`` session (``repro_torch.api``).
2. Find the minimum feasible number of lookup bits (Eqns 9-10).
3. Sweep LUT heights, run the §III decision procedure per R.
4. Pick best area-delay, verify exhaustively (every input code, int64).
5. Evaluate every input code through ``table_eval`` (the ``interp_eval``
   CUDA kernel on a card, its plain version with ``--device cpu``) and
   compare against the Remez (FloPoCo-style) baseline's LUT widths.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import ExploreConfig, Explorer
from repro_torch.core import area as area_model
from repro_torch.core.remez import generate_remez_table
from repro_torch.kernels.interp.ops import table_eval


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="recip",
                    choices=["recip", "log2", "exp2", "exp2neg", "rsqrt",
                             "sigmoid", "silu", "softplus", "gelu"])
    ap.add_argument("--bits", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default=None,
                    help="table cache (default: a fresh temp dir, so the "
                         "tables are generated)")
    args = ap.parse_args(argv)

    cache = args.cache_dir or tempfile.mkdtemp(prefix="torch_quickstart_")
    ex = Explorer(ExploreConfig(kind=args.kind, bits=args.bits,
                                device=args.device, cache_dir=cache))
    spec = ex.config.spec()
    print(f"target: {spec.name}  ({spec.in_bits} -> {spec.out_bits} bits, "
          f"±{spec.ulp} ULP)")

    r_min = ex.min_regions(spec)
    print(f"minimum feasible lookup bits (Eqns 9-10 over all regions): "
          f"R = {r_min}")

    res = ex.explore(spec)
    print(f"\nLUB sweep ({len(res)} feasible heights):")
    for g in res:
        d = g.design
        print(f"  R={d.lookup_bits}  {'lin ' if d.degree == 1 else 'quad'}"
              f"  k={d.k}  widths={d.lut_widths}  area={g.area:7.0f}"
              f"  delay={g.delay:5.2f}  AxD={g.area_delay:9.0f}"
              f"  gen={g.runtime_s:6.2f}s")

    best = res.best
    d = best.design
    ok, worst = d.verify(spec)
    print(f"\nbest area-delay: R={d.lookup_bits}, exhaustively verified over "
          f"2^{spec.in_bits} inputs: {'PASS' if ok else 'FAIL'}")

    codes = torch.arange(1 << spec.in_bits, dtype=torch.int32,
                         device=args.device)
    out_kernel = table_eval(codes, d).cpu().numpy()
    lo, hi = spec.bound_arrays()
    inside = bool(np.all((lo <= out_kernel) & (out_kernel <= hi)))
    where = "CUDA kernel" if codes.is_cuda else "plain version"
    print(f"table_eval ({where}) output within bounds: {inside}")

    try:
        rz = generate_remez_table(spec, d.lookup_bits, degree=d.degree)
        if rz is None:
            raise ValueError("remez infeasible at this height")
        wa, wb, wc = d.lut_widths
        ra, rb, rc = rz.widths
        ad = area_model.estimate(rz.design)
        print(f"\nvs Remez baseline @ R={d.lookup_bits}:")
        print(f"  proposed LUT [{wa},{wb},{wc}] = {wa+wb+wc} bits/row,"
              f"  AxD = {best.area_delay:.0f}")
        print(f"  Remez    LUT [{ra},{rb},{rc}] = {ra+rb+rc} bits/row,"
              f"  AxD = {ad.product:.0f}")
    except ValueError as e:
        print(f"\nRemez baseline failed at this height: {e}")
    return inside and ok


if __name__ == "__main__":
    main()
