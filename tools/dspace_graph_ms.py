#!/usr/bin/env python3
"""Time the port's design-space kernels, a parent tree's against this one's,
on one CUDA card.

    python3 tools/dspace_graph_ms.py --parent DIR

``DIR`` holds the parent commit's ``src/repro_torch/csrc`` (its
``dspace.cu`` and ``datapath.cuh``): ``git archive <commit>
src/repro_torch/csrc | tar -x -C build/parent`` gives
``build/parent/src/repro_torch/csrc``. Without ``--parent`` the script runs
that ``git archive`` of HEAD itself, where the checkout has its ``.git``.
Two libraries are built with nvcc (sm_90a) into the gitignored
``build/dspace_ab/``, each from one ``dspace.cu``: the parent's and this
tree's. Their C entry points are called through ctypes on the cases of
``chip_smoke.py``'s ``dspace_kernel_phase``:

* the envelope kernel through ``repro_envelopes_parity``: recip-16 at
  R = 5, (32, 2048), and R = 8, (256, 256) (``envelopes_parity_batched``);
  R = 5 region 0, (2048,) (``envelopes_parity``); Table I's 16-bit trio at
  R = 5, (3, 32, 2048), and the 12-bit manifest at R = 6
  (``envelopes_parity_fleet``); one random monotone row of 2^16 bounds,
  the widest the kernel stages, and one of 2^16 + 1, read through the
  read-only cache (``envelopes_parity``);
* ``dd_max_rows`` on each batched and fleet case's (M, m) rows: one side
  (a_lo), and both sides of the a-interval as the generator computes them:
  the parent's two launches with their fills and negations (its
  ``_merge_reduce``), this tree's one two-sided launch (its C entry fills
  the outputs with one small kernel before it).

Each row is timed by ``chip_smoke.py``'s ``graph_ms`` (CUDA events around
the replay of one CUDA graph of 50 captured calls) as the median of five
readings, in the order parent / change / change / parent, and the outputs
are compared bitwise. The last line is one JSON object; the rows also go to
``dspace_graph_ms.json`` in ``chip_smoke.py``'s output directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
BUILD = ROOT / "build" / "dspace_ab"
READS = 5  # graph_ms readings a timing; the timing keeps their median
BIG = 3.4e38
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def parent_csrc() -> pathlib.Path:
    """The parent's csrc from ``git archive HEAD`` (needs ``.git``)."""
    out = BUILD / "parent"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    archive = subprocess.run(
        ["git", "-C", str(ROOT), "archive", "HEAD", "src/repro_torch/csrc"],
        capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", str(out)], input=archive, check=True)
    return out / "src" / "repro_torch" / "csrc"


def build_lib(csrc: pathlib.Path, name: str) -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f"{name}.so"
    out = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
         "-I", str(csrc), "-o", str(so),
         str(csrc / "dspace.cu")], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc {name}:\n{out.stdout}{out.stderr}")
    for line in out.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {name} ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    lib.repro_envelopes_parity.argtypes = [_P, _P, _L, _I, _P, _P, _P, _P,
                                           _I, _P]
    lib.repro_dd_max_rows.argtypes = [_P, _P, _L, _I, _P, _I, _P]
    lib.two_sided = hasattr(lib, "repro_dd_max_rows2")  # this tree's API
    if lib.two_sided:
        lib.repro_dd_max_rows2.argtypes = [_P, _P, _L, _I, _P, _P, _I, _P]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="the parent's src/repro_torch/csrc")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dspace_graph_ms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import OUT, TABLE1_16, graph_ms
    from repro_torch.api import spec_for
    from repro_torch.api.library import DEFAULT_LIBRARY_KINDS
    from repro_torch.core.funcspec import get_spec
    from repro_torch.kernels.dspace.ops import _interleave

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    parent_src = pathlib.Path(args.parent) if args.parent else parent_csrc()
    libs = {"parent": build_lib(parent_src, "parent"),
            "change": build_lib(CSRC, "change")}
    dev = torch.device("cuda", 0)

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def envelopes(lib, L, U):
        n = L.shape[-1]
        outs = [torch.empty_like(L) for _ in range(4)]
        rc = lib.repro_envelopes_parity(L.data_ptr(), U.data_ptr(),
                                        L.numel() // n, n,
                                        *(o.data_ptr() for o in outs), 0,
                                        stream())
        assert rc == 0, rc
        return outs

    def dd_one(lib, g, h):
        rows, t = g.shape
        # the parent merges into an output filled here, this tree's C entry
        # fills its own
        out = (torch.empty(rows, device=dev) if lib.two_sided
               else torch.full((rows,), -BIG, device=dev))
        assert lib.repro_dd_max_rows(g.data_ptr(), h.data_ptr(), rows, t,
                                     out.data_ptr(), 0, stream()) == 0
        return out

    def dd_both_parent(lib, mt, st):  # the parent's _merge_reduce
        return dd_one(lib, mt, st), -dd_one(lib, -st, -mt)

    def dd_both_change(lib, mt, st):
        rows, t = mt.shape
        lo, hi = torch.empty((2, rows), device=dev)
        assert lib.repro_dd_max_rows2(mt.data_ptr(), st.data_ptr(), rows, t,
                                      lo.data_ptr(), hi.data_ptr(), 0,
                                      stream()) == 0
        return lo, hi

    trio = [get_spec(k, 16, **kw) for k, kw in TABLE1_16]
    recip = trio[0]
    cases = []
    for r in (5, 8):
        L, U = recip.region_bounds(r)
        cases.append(("envelopes_parity_batched", f"recip16 R={r}", f32(L),
                      f32(U)))
    L, U = recip.region_bounds(5)
    cases.append(("envelopes_parity", "recip16 R=5 region 0", f32(L[0]),
                  f32(U[0])))
    stack = [s.region_bounds(5) for s in trio]
    cases.append(("envelopes_parity_fleet", "Table I 16-bit trio R=5",
                  f32([b[0] for b in stack]), f32([b[1] for b in stack])))
    man = [spec_for(k).region_bounds(6) for k in DEFAULT_LIBRARY_KINDS]
    cases.append(("envelopes_parity_fleet", "12-bit manifest R=6",
                  f32([b[0] for b in man]), f32([b[1] for b in man])))
    rng = np.random.default_rng(16)
    for n in (1 << 16, (1 << 16) + 1):
        L = np.cumsum(rng.integers(0, 3, n))
        cases.append(("envelopes_parity", f"random row of {n}", f32(L),
                      f32(L + rng.integers(0, 4, n))))

    rows = []

    def timed(name, case, shape, fns):
        """fns: {label: fn}; parent / change / change / parent."""
        outs = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        ref = outs["parent"]
        same = {k: all(torch.equal(a, b) for a, b in zip(o, ref))
                for k, o in outs.items()}
        order = ["parent", "change", "change", "parent"]
        reads = {k: [] for k in fns}
        for k in order:
            reads[k].append(float(np.median(
                [graph_ms(fns[k])[0] for _ in range(READS)])))
        row = dict(name=name, case=case, shape=list(shape), graph_ms=reads,
                   bitwise_equal_parent=same)
        rows.append(row)
        print(f"{name} {case} {tuple(shape)}: " + "; ".join(
            f"{k} {' / '.join(f'{v * 1e3:.2f}' for v in vs)} us"
            for k, vs in reads.items()) + f"; bitwise == parent {same}")
        if not all(same.values()):
            raise AssertionError(f"{name} {case}: outputs differ {same}")

    dd_inputs = []
    for name, label, L, U in cases:
        n = L.shape[-1]
        Lr, Ur = L.reshape(-1, n), U.reshape(-1, n)
        timed(name, label, L.shape,
              {k: (lambda lib=lib: envelopes(lib, Lr, Ur))
               for k, lib in libs.items()})
        if name != "envelopes_parity":
            big, m = _interleave(*envelopes(libs["change"], Lr, Ur))
            dd_inputs.append((label, big[:, 1:].contiguous(),
                              m[:, 1:].contiguous()))
    for label, mt, st in dd_inputs:
        timed("dd_max_rows", f"{label} a_lo", mt.shape,
              {k: (lambda lib=libs[k]: (dd_one(lib, mt, st),))
               for k in ("parent", "change")})
        timed("dd_max_rows", f"{label} a_lo + a_hi", mt.shape,
              {"parent": lambda: dd_both_parent(libs["parent"], mt, st),
               "change": lambda: dd_both_change(libs["change"], mt, st)})
    result = {"device": card, "rows": rows}
    OUT.mkdir(exist_ok=True)
    (OUT / "dspace_graph_ms.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
