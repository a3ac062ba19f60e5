"""Serving launcher: continuous-batching greedy decoding on random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --numerics interp --requests 6 --slots 4 --prompt-len 64 --max-new 16

runs the full-width model (``--arch yi_6b`` or ``deepseek_moe_16b``) on the
CUDA card; ``--smoke --device cpu`` runs the reduced config on the CPU
through the kernels' plain versions. The flags and defaults are the
reference launcher's: ``--numerics exact|interp`` (``interp-fused`` names
the same engine: interp numerics always serve through the library-bound
kernels here), default the config's own numerics; 8 requests of 12 new
tokens. ``--library PATH`` serves a saved :class:`InterpLibrary` (v1 or v2,
e.g. one from ``Explorer.compile_segmented()``) instead of the default one,
``--save-library PATH`` writes the library the engine serves; either
implies interp numerics and is refused with ``--numerics exact``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import INTERP_BACKENDS, Request, ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--numerics", choices=["exact", "interp", "interp-fused"],
                    default=None,
                    help="default: the config's own numerics")
    ap.add_argument("--library", default=None,
                    help="serve from this saved InterpLibrary (json/npz base)")
    ap.add_argument("--save-library", default=None,
                    help="write the library the engine serves here")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.numerics:
        cfg = cfg.replace(numerics=args.numerics)
    if args.library or args.save_library:
        if args.numerics == "exact":
            ap.error("--library/--save-library require interp numerics")
        if cfg.numerics not in INTERP_BACKENDS:
            cfg = cfg.replace(numerics="interp")  # the flags imply it

    dev = resolve(args.device)
    library = (InterpLibrary.load(args.library, device=dev) if args.library
               else None)
    params = tf.init_params(cfg, seed=args.seed, device=dev)
    eng = ServeEngine(cfg, params, slots=args.slots, cache_len=args.cache_len,
                      horizon=args.horizon, library=library, device=dev)
    if args.save_library:
        print(f"saved library -> {eng.library.save(args.save_library)}")
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        n = max(1, args.prompt_len - i % 4)
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        eng.submit(Request(i, prompt, max_new=args.max_new))
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.rid):
        print(f"request {r.rid}: {len(r.prompt)} prompt -> {r.out}")
    n_tok = sum(len(r.out) for r in done)
    print(json.dumps({"device": str(dev), "numerics": cfg.numerics,
                      "tokens": n_tok, "seconds": dt,
                      "rom_sha": eng.library and eng.library.rom_sha(),
                      "stats": eng.stats}))


if __name__ == "__main__":
    main()
