"""Serving with certified table numerics on the PyTorch port: compile ->
save -> load -> serve (twin of ``examples/serve_interp.py``).

    PYTHONPATH=src python examples/torch_serve_interp.py [--arch yi_6b] [--device cuda]

1. ``Explorer.compile()`` packs every table the interp numerics touch
   into one ``InterpLibrary`` (generating + verifying on a cold cache);
2. ``library.save(path)`` persists it as npz + json manifest;
3. a serving process ``InterpLibrary.load``s the artifact and constructs
   its ``ServeEngine`` from it: no exploration at serve time.

The same request stream is served with exact transcendentals and with the
loaded library in every softmax / SiLU / rsqrt (the fused kernels on a
card, their plain versions with ``--device cpu``), reporting token
agreement plus the certified worst-case softmax error bound. The model is
the architecture's smoke config with random weights.
"""
from __future__ import annotations

import argparse
import pathlib
import tempfile

import numpy as np

from repro_torch.api import ExploreConfig, Explorer, InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import softmax_ulp_bound
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--library", default=None,
                    help="library artifact path: loaded if it exists, "
                         "compiled + saved there otherwise (default: a "
                         "temp dir)")
    args = ap.parse_args(argv)

    base = get_smoke_config(args.arch)
    params = tf.init_params(base, 0, args.device)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, base.vocab_size,
                            args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]

    root = pathlib.Path(args.library or
                        tempfile.mkdtemp(prefix="torch_interp_lib_"))
    path = root / "library"
    manifest = path.with_suffix(".json")
    if not manifest.exists():
        with Explorer(ExploreConfig(device=args.device,
                                    cache_dir=str(root / "tables"))) as ex:
            manifest = ex.compile().save(path)
        print(f"compiled library -> {manifest}")

    library = InterpLibrary.load(manifest, device=args.device)
    print(f"loaded {manifest}: rom_sha {library.rom_sha()}")

    outs = {}
    for numerics in ("exact", "interp-fused"):
        cfg = base.replace(numerics=numerics)
        eng = ServeEngine(cfg, params, slots=args.slots, cache_len=128,
                          library=library if numerics != "exact" else None,
                          device=args.device)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, args.max_new))
        done = sorted(eng.run(), key=lambda r: r.rid)
        eng.close()
        outs[numerics] = [list(r.out) for r in done]
        total = sum(len(r.out) for r in done)
        print(f"{numerics:12s}: served {len(done)} requests, {total} tokens")

    agree = [np.mean([a == b for a, b in zip(ea, ia)])
             for ea, ia in zip(outs["exact"], outs["interp-fused"])]
    print(f"\nper-request greedy token agreement exact-vs-interp: "
          f"{[f'{a:.2f}' for a in agree]}")
    bound = softmax_ulp_bound(library.meta("exp2neg"), library.meta("recip"))
    print(f"certified softmax relative error bound of the tables: "
          f"{bound:.2e}")
    return outs


if __name__ == "__main__":
    main()
