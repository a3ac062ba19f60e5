"""Re-targeting demo on the PyTorch port (twin of
``examples/retarget_hardware.py``).

    PYTHONPATH=src python examples/torch_retarget_hardware.py [--bits 12] [--custom] [--device cuda]

The region envelopes (the expensive, target-independent part of the design
space) are computed ONCE inside an ``Explorer`` session; each registered
``Target`` then explores the *same* cached space with its own decision
procedure and cost model (§III: "Targeting alternative hardware
technologies simply requires a modified decision procedure"). Registering
a fourth technology is ``@register_target("name")`` + ~20 lines: try it
with ``--custom``. ``--device`` is where the session's device paths and
compiled libraries live (``cuda`` by default, ``cpu`` for the plain
versions).
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.api import (DecisionPolicy, ExploreConfig, Explorer,
                             list_targets, register_target)
from repro_torch.core import area as area_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=12)
    ap.add_argument("--kind", default="recip")
    ap.add_argument("--custom", action="store_true",
                    help="also register + run a custom low-power target")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default=None)
    args = ap.parse_args(argv)

    if args.custom and "low-power" not in list_targets():
        @register_target("low-power")
        class LowPower:
            """Leakage-dominated node: LUT bits are nearly free, switching in
            the multipliers is not — rank by multiplier area only."""
            policy = DecisionPolicy(prefer_linear=True)

            def estimate(self, design):
                ad = area_model.estimate(design)
                lut_bits = (1 << design.lookup_bits) * sum(design.lut_widths)
                return area_model.AreaDelay(ad.area - 0.25 * lut_bits,
                                            ad.delay)

            def objective(self, design, ad):
                return ad.area

    cache = args.cache_dir or tempfile.mkdtemp(prefix="torch_retarget_")
    with Explorer(ExploreConfig(kind=args.kind, bits=args.bits,
                                device=args.device, cache_dir=cache)) as ex:
        spec = ex.config.spec()
        print(f"one session, one design space ({spec.name}), "
              f"{len(list_targets())} targets:\n")
        for tname in list_targets():
            res = ex.explore(spec, target=tname)
            assert res, f"no feasible designs for target {tname}"
            d = res.best.design
            rows = 1 << d.lookup_bits
            front = ",".join(f"R{e.lookup_bits}" for e in res.pareto())
            print(f"  {tname:10s}: R={d.lookup_bits} "
                  f"{'lin' if d.degree == 1 else 'quad'}"
                  f" widths={d.lut_widths} LUT={rows}x{sum(d.lut_widths)}b"
                  f" ({rows * sum(d.lut_widths) / 8192:.1f} KiB)"
                  f" area={res.best.area:.0f} delay={res.best.delay:.2f}"
                  f"  pareto=[{front}]")
        stats = ex.envelope_stats
        print(f"\nenvelope computations: {stats['computed']} "
              f"(cache hits: {stats['hits']}) — the space was generated "
              f"once; only the decision procedure changed between targets "
              f"(the paper's §III claim).")
    return stats


if __name__ == "__main__":
    main()
