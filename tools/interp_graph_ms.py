#!/usr/bin/env python3
"""Time the port's one-slot table reads at their shapes on one CUDA card.

    python3 tools/interp_graph_ms.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
two trees (a parent commit unpacked with ``git archive`` and the change) can
be timed in one call on one card, in turns. It prints the ``graph_ms`` of

* ``rom_eval`` on the silu slot of the default library and of the same
  manifest segmented (``compile_segmented``), on Yi-6B's silu codes at
  decode (4, 1, 11008) and in a 512-token prefill (1, 512, 11008);
* ``interp_eval`` on the recip-12 design's 4096 codes and on the silu
  design at (1, 512, 11008);
* ``library_eval`` (default library) and ``library_walk`` (segmented) with
  one id at both silu shapes, the guard of the shared one-slot body;
* the yardsticks on the same tensors: ``F.silu`` on the gate the codes come
  from, ``torch.reciprocal`` on recip's decoded inputs;

each timed by ``chip_smoke.py``'s ``graph_ms`` (CUDA events around the
replay of one CUDA graph of 50 captured calls; the median of five
readings, all five kept), and at (1, 512, 11008) each again with a cold
L2 (``cold_ms``: the median of CUDA event pairs around one call right
after a 128 MB write). The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((4, 1, 11008), (1, 512, 11008))
READS = 5  # graph_ms readings a row; the row keeps their median


def cold_ms(fn, flush, reps: int = 20) -> float:
    """Median device ms of ``fn()`` enqueued right behind ``flush()``: the
    flush keeps the stream busy, so the events hold the kernel alone."""
    import torch

    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("interp_graph_ms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    from chip_smoke import graph_ms, l2_flush
    from repro_torch.api import Explorer, ExploreConfig
    from repro_torch.api.library import (DEFAULT_TABLE_KEY, TABLES_DIR,
                                         InterpLibrary)
    from repro_torch.core.table import TableDesign
    from repro_torch.kernels.interp.kernel import interp_eval_cuda
    from repro_torch.kernels.interp.ops import (library_eval, library_walk,
                                                rom_eval)
    from repro_torch.numerics.ops import _quantize

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    uni = InterpLibrary.default_library(dev)
    with tempfile.TemporaryDirectory() as tmp:
        host = Explorer(ExploreConfig(device="cpu", cache_dir=tmp)
                        ).compile_segmented()
    seg = InterpLibrary(host.coeffs.to(dev), host.metas).seal()
    designs = {k: TableDesign.from_dict(json.loads(
        (TABLES_DIR / f"{k}_{DEFAULT_TABLE_KEY}.json").read_text()))
        for k in ("recip", "silu")}
    m = uni.meta("silu")
    flush = l2_flush(dev)
    g = torch.Generator(device=dev).manual_seed(20)

    def dp_of(d):
        return dict(eval_bits=d.eval_bits, k=d.k, sq_trunc=d.sq_trunc,
                    lin_trunc=d.lin_trunc, degree=d.degree)

    rows = []

    def row(name, shape, fn, cold=False, **extra):
        reads = [graph_ms(fn)[0] for _ in range(READS)]
        r = dict(name=name, shape=list(shape),
                 graph_ms=float(np.median(reads)), graph_reads=reads, **extra)
        if cold:
            r["cold_ms"] = cold_ms(fn, flush)
        rows.append(r)
        print(f"{args.label} {name} {shape} {extra}: graph "
              f"{r['graph_ms'] * 1e3:.3f} us"
              + (f", cold L2 {r['cold_ms'] * 1e3:.3f} us" if cold else ""))

    for shape in SHAPES:
        gate = (torch.randn(shape, device=dev, generator=g) * 3
                ).to(torch.bfloat16)
        xc = torch.clamp(gate.float(), m.act_lo, m.act_hi - 1e-6)
        codes = _quantize((xc - m.act_lo) / (m.act_hi - m.act_lo), m.in_bits)
        cold = shape == SHAPES[-1]
        for label, lib in (("uniform", uni), ("segmented", seg)):
            row("rom_eval", shape, lambda: rom_eval(codes, lib, "silu"),
                cold, library=label)
        row("library_eval", shape,
            lambda: library_eval(codes, uni.func_id("silu"), uni.coeffs,
                                 uni.meta_rows()), cold, library="uniform")
        walk, wdp = seg.walk_rows()
        row("library_walk", shape,
            lambda: library_walk(codes, seg.func_id("silu"), seg.coeffs,
                                 walk, wdp), cold, library="segmented")
        if cold:
            d = designs["silu"]
            coeffs = d.device_coeffs(dev)
            row("interp_eval", shape,
                lambda: interp_eval_cuda(codes, coeffs, **dp_of(d)), cold,
                case="silu")
        row("F.silu", shape, lambda: F.silu(gate), cold)
    d = designs["recip"]
    codes = torch.arange(1 << d.in_bits, dtype=torch.int32, device=dev)
    coeffs = d.device_coeffs(dev)
    x = 1.0 + codes.float() / codes.numel()
    row("interp_eval", [codes.numel()],
        lambda: interp_eval_cuda(codes, coeffs, **dp_of(d)), case="recip")
    row("torch.reciprocal", [codes.numel()], lambda: torch.reciprocal(x))
    print(json.dumps({"label": args.label, "device": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
