#!/usr/bin/env python3
"""Card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a). It

1. prints the card's name and power limit and the torch / CUDA versions,
   and builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. holds the design-space generator's envelope kernels
   (``envelopes_parity``, ``envelopes_parity_batched``,
   ``envelopes_parity_fleet``) and the a-interval kernel ``dd_max_rows``
   (one side, and both sides in one launch as the generator runs it)
   against their plain versions on the card, bitwise, at the shapes the
   generator gives them and on the steep rows (-2^24 per code, 16 and 2048
   wide) through all three envelope entry points, and times them;
3. runs the generator through its entry points: Table I's 16-bit
   reciprocal under ``engine="pallas"`` on the card against the exact numpy
   engine (same minimum region count, a design that verifies over all
   65536 codes and evaluates on the card bit-exact), then compiles the
   default 12-bit library twice on the card (the fleet device path,
   ``mesh=2``, and ``engine="pallas"``), each to the vendored library's
   ``rom_sha``, and evaluates every generated table through the
   ``interp_eval`` kernel against ``TableDesign.eval_int``; then the 16-bit
   log2 and exp2 rows under both engines; checks that every envelope
   launch came with one two-sided ``dd_max_rows`` launch; and reruns recip
   16 under ``torch.profiler`` (device time in the envelope kernels) and
   under ``cProfile`` (the five §III functions of ``core/decision.py``,
   ``core/batched.py`` and ``core/fleet.py`` with the most cumulative
   host time);
4. segments the default manifest on the card: ``compile_segmented()``
   under ``engine="pallas"`` (fresh table cache) to the ROM-v2 library
   ``f775a828748d4ea9`` (8, 42, 3), 153 rows, beside the same call under the
   exact engine; every slot evaluates through the ``rom_eval`` kernel (the
   in-kernel read every fused kernel inlines) equal to its design's int64
   ``eval_int``; the v2 artifact is saved and loaded back unchanged;
5. holds ``interp_eval``, ``library_walk``, ``rom_eval`` and the four
   serving kernels against their plain versions on the card (raising on a
   mismatch beyond the stated tolerance; the activation kernel at every
   shape the served models hand it) and times kernel, plain version and a
   yardstick PyTorch call (device time from the profiler, read only from
   traces that hold every launch of the kernel; ``graph_ms``, the replay of
   one CUDA graph of 50 captured calls between CUDA events, for every
   kernel and yardstick; call time from CUDA events), the flash kernel
   against its tile twin with the kernel's query tile and key splits, on
   the uniform library compiled in step 3 and, for the walk and the fused
   kernels, on the segmented one of step 4 (``rom_eval`` on both, and with
   ``interp_eval`` on the silu design also at Yi-6B's prefill width with a
   cold L2); the
   served activation (``FusedInterpNumerics.silu``, one ``act_lib``
   launch and no other device op) at every shape the served models hand
   it, in their layout (the gate half of a SwiGLU product, read in place),
   on both libraries, bitwise against the eager chain (the float glue
   around the int32 kernel, whose launches stand for ``library_eval`` and
   ``library_walk`` in the kernels line) and the plain version, timed
   beside the chain and ``F.silu`` on the same view, with each of its two
   bodies forced (and, at Yi-6B's prefill, with a cold L2, as the int32
   kernels); ``rmsnorm_lib`` at the served models' decode and prefill
   shapes with its two bodies and a gamma in bf16 and float32 against the
   plain version, the served norm (``apply_norm``, the bf16 scale as
   stored) one launch and one device op (CUDA graph nodes), timed beside
   ``F.rms_norm`` with the same gamma, at every thread count per row and,
   at Yi-6B's prefill, with a cold L2; ``softmax_lib`` at the router's
   decode and prefill shapes, a wide bf16 row and the per-table phase's
   two large calls, both bodies e bitwise and the output bitwise the twin
   with the kernels' sum order, the served router call one launch and one
   device op, timed beside ``torch.softmax`` on the same tensor with each
   body, with and without the float table of exp2neg outputs, at every
   thread count per row and, at (16384, 512), with a cold L2;
6. runs the per-table path at full Yi-6B width: 10-bit exp2neg, recip and
   rsqrt designs generated on the card into a fresh cache, the vendored
   12-bit R5 designs and the default R6 ones, each set through
   ``approx_rmsnorm_fused``, ``approx_softmax_fused`` and
   ``attention_fused`` (the ``rmsnorm_tab``, ``softmax_tab`` and
   ``flash_attn_tab`` kernels, launch counts read right after), each kernel
   held against its plain version and, on R6, bitwise against its library
   twin on the uniform library of step 3, and timed;
7. holds the backends' other activations (gelu, sigmoid, softplus, tanh:
   one ``act_lib`` launch each on their slots) bitwise against their plain
   versions at the served decode and prefill shapes on both libraries;
8. serves 6 requests on full-width Yi-6B (bf16, random weights from a
   seeded generator, the uniform library) through the continuous-batching
   engine with interp-fused numerics, twice: on a graph engine (the main
   path: each tick the replay of one captured CUDA graph per chunk size)
   and on an eager one (``graph=False``); asserts every request completes
   with in-vocabulary tokens and finite logits, the two engines' token
   streams and final caches (k, v, pos) bitwise equal, that each kernel
   launched exactly its expected count per forward pass
   (``stats["launches"]``, which adds each graph's launches on every
   replay; the wrappers' global counters see the eager engine's every
   launch and the graph engine's prefills), and that each request's first
   token matches a plain-version prefill on the card (tie-aware); times
   both engines' ticks at 4 live slots (wall ms per decode step, the
   busy share from torch.profiler); then, on the same weights, the serial
   oracle (exact numerics, one decode and a host argmax per token) against
   the graph tick, bitwise, and the fault phase: a ROM bit flip at
   construction serving exact numerics' tokens, NaN ticks retiring slots
   and moving the engine to the serial rung with guarded numerics, and a
   journaled run killed at a crash point resuming to the uninterrupted
   streams;
9. frees Yi-6B and serves (graph and eager) full-width DeepSeekMoE-16B
   (28 layers, 64 routed experts top-6 + 2 shared, a dense layer 0; the
   router's softmax through the ``softmax_lib`` kernel), first on the
   uniform library, then on the same weights on the segmented library,
   where the activations and every table read of the fused kernels go
   through the segment decode: the same launches per forward;
10. prints the throughput, a ``{"kernels": [...]}`` JSON line and, last,
   ``{"ok": true, "device": {...}}``.

Any failure raises (non-zero exit) before the last line. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import functools
import gc
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM data-sheet peaks (dense): HBM bandwidth, bf16 tensor-core and
# float32 CUDA-core rates. Integer glue is counted at the float32 rate.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SERVE_LENGTHS = (17, 64, 200, 511, 33, 128)
# the default library's checksum (the vendored tables; the reference's
# float32 device paths give it too)
DEFAULT_ROM_SHA = "12aa483ae8456c2f"
# the default manifest segmented (ROM v2): checksum, shape and rows used
SEG_ROM_SHA = "f775a828748d4ea9"
SEG_ROM_SHAPE = (8, 42, 3)
SEG_ROWS = 153
# Table I's published 16-bit rows (benchmarks/table1.py)
TABLE1_16 = (("recip", {}), ("log2", {"out_bits": 17}),
             ("exp2", {"out_bits": 16}))
ENVELOPE_KERNELS = ("envelopes_parity", "envelopes_parity_batched",
                    "envelopes_parity_fleet", "dd_max_rows")
MAX_NEW = 16
SLOTS, CACHE_LEN, HORIZON = 4, 1024, 8


def timed(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


EVENT_TIMED: list[str] = []  # measurements the profiler could not time
SHORT_TRACES: list[str] = []  # kernel times read from a trace that lost some

# each hand-written kernel's symbol, as the profiler names its launches
KERNEL_SYMBOLS = {"library_eval": "table_read_kernel<false",
                  "library_walk": "table_read_kernel<true",
                  # the served activation: the float glue around the
                  # library_eval / library_walk table read, in one kernel
                  "act_lib": "act_lib_kernel",
                  "rmsnorm_lib": "rmsnorm_kernel",
                  "flash_attn_lib": "flash_attn_kernel",
                  "softmax_lib": "softmax_kernel<",
                  # the per-table entry points run the same bodies
                  "rmsnorm_tab": "rmsnorm_kernel",
                  "flash_attn_tab": "flash_attn_kernel",
                  "softmax_tab": "softmax_kernel<",
                  # the one-slot body on a table row the host passes
                  "rom_eval": "slot_read_kernel",
                  "interp_eval": "slot_read_kernel",
                  "envelopes_parity": "envelopes_parity_kernel",
                  "envelopes_parity_batched": "envelopes_parity_kernel",
                  "envelopes_parity_fleet": "envelopes_parity_kernel",
                  "dd_max_rows": "dd_max_rows_kernel"}
# the kernels a serving profile reads
SERVE_KERNELS = ("act_lib", "rmsnorm_lib", "flash_attn_lib", "softmax_lib")


def device_ms(fn, iters: int = 10, label: str = "",
              kernel: str | None = None, symbol: str | None = None,
              own: bool = False) -> float:
    """Mean device milliseconds of the CUDA kernels one ``fn()`` launches,
    from torch.profiler (CUPTI): the kernels' own execution time, without
    the host's launch gaps. The profiler on this card loses events from a
    varying share of traces. With ``kernel`` (a hand-written kernel's name)
    that kernel's time per launch is read from its own events, found by
    its symbol and divided by their count, times the launches one ``fn()``
    adds to its count; a trace that lost some of them is retried and the
    fullest is kept (listed in ``SHORT_TRACES``). The plain versions (no
    ``kernel``) take any trace with device time. A trace that stays empty
    sends the call to ``backlog_ms``, and ``label`` is listed in
    ``EVENT_TIMED``. ``symbol`` overrides the kernel's symbol (a kernel
    counted under another's name; without ``kernel``, a library kernel
    ``fn`` launches once); ``own`` leaves out the device time of the other
    kernels ``fn`` launches (an L2 flush before the call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build

    sym = symbol or (KERNEL_SYMBOLS[kernel] if kernel else None)
    before = build.LAUNCHES[kernel] if kernel else 0
    fn()
    torch.cuda.synchronize()
    per_call = build.LAUNCHES[kernel] - before if kernel else int(bool(sym))
    if kernel and not per_call:
        raise AssertionError(f"{label}: fn() does not launch {kernel}")
    best = None  # (launches seen, their device us, other device us)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(_dev_us(e) for e in events)
        if not sym:
            if total > 0:
                return total / iters / 1e3
            continue
        mine = [e for e in events if sym in e.key]
        seen = sum(int(e.count) for e in mine)
        if seen and (best is None or seen > best[0]):
            mine_us = sum(_dev_us(e) for e in mine)
            best = (seen, mine_us, total - mine_us)
        if seen == per_call * iters:
            break
    if best:
        seen, own_us, rest = best
        if seen < per_call * iters:
            SHORT_TRACES.append(f"{label}: {seen} of {per_call * iters} "
                                f"{kernel} launches")
        return (own_us / seen * per_call
                + (0 if own else rest / iters)) / 1e3
    print(f"  torch.profiler recorded no device time for "
          f"{kernel or ''} {label or fn}: timed with CUDA events on a "
          f"backlogged stream instead")
    EVENT_TIMED.append(label or repr(fn))
    return backlog_ms(fn, iters=iters)


def graph_ms(fn, n: int = 50, reps: int = 3) -> tuple[float | None,
                                                     str | None]:
    """Device milliseconds per call of ``fn()`` from a CUDA graph that
    captures ``n`` calls, replayed ``reps`` times between two CUDA events:
    no host launch gaps, no profiler. Returns (ms, None), or (None, the
    reason) where ``fn()`` cannot be captured (it syncs with the host)."""
    import torch

    fn()  # builds, fills the caches a first call fills
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as err:
        return None, f"syncs with the host: {str(err)[:160]}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
    except RuntimeError as err:
        torch.cuda.synchronize()
        return None, f"capture failed: {str(err)[:160]}"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del graph
    return ms, None


PHASE_S: dict[str, float] = {}


def phase(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds printed and kept in
    ``PHASE_S`` (the report's ``phase_s``)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f} ms"


def _share(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


def graph_cols(fn, yard=None) -> dict:
    """``graph_ms`` of a kernel's call and ``library_graph_ms`` of its
    yardstick (None without one), with the reason beside a null reading."""
    out = {}
    for key, f in (("graph_ms", fn), ("library_graph_ms", yard)):
        ms, why = graph_ms(f) if f is not None else (None, "no yardstick")
        out[key] = ms
        if why:
            out[f"{key}_null"] = why
            if f is not None:
                print(f"  {key}: not measured ({why})")
    return out


def backlog_ms(fn, iters: int = 10) -> float:
    """Median device milliseconds of one ``fn()`` from a CUDA event pair
    around each call, enqueued behind a spin kernel (``torch.cuda._sleep``,
    about 1 ms per call) so that the stream holds a backlog and the host's
    launch gaps do not enter. A call that waits for the device from the
    host (a pageable copy) still lets them in."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(2_000_000 * iters)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _dev_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else getattr(e, "self_cuda_time_total", 0))


def bound(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def envelope_work(n: int) -> tuple[int, int]:
    """(even, odd) (center, offset) pairs of one envelope row of width n:
    the pairs this row's data needs (the kernel stops at the row's ends)."""
    j = np.arange(n)
    even = np.minimum(j, n - 1 - j).sum()
    odd = np.maximum(np.minimum(j, n - 2 - j) + 1, 0).sum()
    return int(even), int(odd)


def act_shapes() -> tuple[tuple[int, ...], ...]:
    """The silu code shapes the served models hand the activation kernel,
    one function id for every element: Yi-6B's SwiGLU at decode (4 slots)
    and in a 512-token prefill; DeepSeekMoE's routed-expert groups (slots,
    experts, capacity + the scratch row, d_expert), its shared experts and
    its dense layer 0, at decode and in the longest served prefill."""
    from repro_torch.configs import deepseek_moe_16b, yi_6b
    from repro_torch.models.moe import _capacity

    yi, moe = yi_6b.CONFIG, deepseek_moe_16b.CONFIG
    m = moe.moe
    out = [(SLOTS, 1, yi.d_ff), (1, 512, yi.d_ff)]
    for b, s in ((SLOTS, 1), (1, max(SERVE_LENGTHS))):
        out += [(b, m.n_experts, _capacity(s, moe) + 1, m.d_expert),
                (b, s, m.n_shared * m.d_expert), (b, s, moe.first_dense_ff)]
    return tuple(out)


def dspace_kernel_phase(dev):
    """The envelope kernels and dd_max_rows against their plain versions,
    bitwise, at the generator's shapes; returns rows for the kernels line
    and details."""
    import torch

    from repro_torch.api import spec_for
    from repro_torch.api.library import DEFAULT_LIBRARY_KINDS
    from repro_torch.core.funcspec import get_spec
    from repro_torch.kernels.dspace import kernel as dk
    from repro_torch.kernels.dspace import ops, ref
    from repro_torch.kernels.dspace.ops import _interleave

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    trio = [get_spec(k, 16, **kw) for k, kw in TABLE1_16]
    recip = trio[0]
    cases = []  # (kernel, label, L, U)
    for r in (5, 8):
        L, U = recip.region_bounds(r)
        cases.append(("envelopes_parity_batched", f"recip16 R={r}",
                      f32(L), f32(U)))
    L, U = recip.region_bounds(5)
    cases.append(("envelopes_parity", "recip16 R=5 region 0", f32(L[0]),
                  f32(U[0])))
    stack = [s.region_bounds(5) for s in trio]
    cases.append(("envelopes_parity_fleet", "Table I 16-bit trio R=5",
                  f32([b[0] for b in stack]), f32([b[1] for b in stack])))
    man = [spec_for(k).region_bounds(6) for k in DEFAULT_LIBRARY_KINDS]
    cases.append(("envelopes_parity_fleet", "12-bit manifest R=6",
                  f32([b[0] for b in man]), f32([b[1] for b in man])))
    cuda = {"envelopes_parity": dk.envelopes_parity_cuda,
            "envelopes_parity_batched": dk.envelopes_parity_batched_cuda,
            "envelopes_parity_fleet": dk.envelopes_parity_fleet_cuda}
    # the steep rows (slopes of -2^24 a code: float32 rounds the
    # numerators) through all three entry points, bitwise
    for n in (16, 2048):
        L = f32(-(2.0 ** 24) * np.arange(n))
        U = f32(-(2.0 ** 24) * np.arange(n) + 8)
        want = ref.envelopes_parity_ref(L[None], U[None])
        for name, fn in cuda.items():
            lead = {"envelopes_parity": (), "envelopes_parity_batched": (1,),
                    "envelopes_parity_fleet": (1, 1)}[name]
            got = fn(L.reshape(*lead, n), U.reshape(*lead, n))
            torch.cuda.synchronize()
            if not all(torch.equal(g.reshape(1, n), w)
                       for g, w in zip(got, want)):
                raise AssertionError(f"{name} steep ({n},) differs from plain")
        print(f"steep rows ({n},) through the three envelope entry points: "
              f"bitwise equal to the plain version (tolerance 0)")
    rows, details = {}, []
    dd_inputs = []
    for name, label, L, U in cases:
        n = L.shape[-1]
        n_rows = L.numel() // n
        got = cuda[name](L, U)
        want = ref.envelopes_parity_ref(L.reshape(n_rows, n),
                                        U.reshape(n_rows, n))
        torch.cuda.synchronize()
        err = max(float((g.reshape(n_rows, n) - w).abs().max())
                  for g, w in zip(got, want))
        same = all(torch.equal(g.reshape(n_rows, n), w)
                   for g, w in zip(got, want))
        print(f"{name} {label} {tuple(L.shape)}: bitwise equal {same}, "
              f"max_abs_err {err} (tolerance 0, bitwise)")
        if not same:
            raise AssertionError(f"{name} {label} differs from plain")
        even, odd = envelope_work(n)
        # each pair: two divided differences of one add/sub pair, one
        # divide and one min/max each = 8 operations
        b_ms, b_by = bound(6 * 4 * n_rows * n, 8 * n_rows * (even + odd),
                           F32_FLOPS)
        row = dict(name=name, shape=list(L.shape), case=label,
                   max_abs_err=err, tolerance=0,
                   ms=device_ms(lambda: cuda[name](L, U), label=label,
                                 kernel=name),
                   call_ms=timed(lambda: cuda[name](L, U)),
                   plain_ms=device_ms(lambda: ref.envelopes_parity_ref(
                       L.reshape(n_rows, n), U.reshape(n_rows, n)), iters=1,
                       label=f"plain {label}"),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   pairs=n_rows * (even + odd),
                   **graph_cols(lambda: cuda[name](L, U)))
        details.append(row)
        rows.setdefault(name, row)
        if name != "envelopes_parity":
            big, m = _interleave(*(g.reshape(n_rows, n) for g in got))
            dd_inputs.append((label, big[:, 1:].contiguous(),
                              m[:, 1:].contiguous()))
    for label, mt, st in dd_inputs:
        # both sides in one launch, as _merge_reduce runs it
        got = dk.dd_max_rows2_cuda(mt, st)
        want = ref.dd_max_rows2_ref(mt, st)
        one = (dk.dd_max_rows_cuda(mt, st), -dk.dd_max_rows_cuda(-st, -mt))
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, w) and torch.equal(g, o)
                   for g, w, o in zip(got, want, one))
        n_rows, t = mt.shape
        print(f"dd_max_rows {label} a_lo + a_hi, one launch ({n_rows}, {t}): "
              f"bitwise equal to dd_max_rows2_ref and to the two one-sided "
              f"launches {same}, max_abs_err {err} (tolerance 0, bitwise)")
        if not same:
            raise AssertionError(f"dd_max_rows {label} two-sided differs")
        pairs = 2 * n_rows * t * (t - 1) // 2  # both sides' pairs
        b_ms, b_by = bound(4 * (2 * n_rows * t + 2 * n_rows), 3 * pairs,
                           F32_FLOPS)
        row = dict(name="dd_max_rows", shape=[n_rows, t],
                   case=f"{label} a_lo + a_hi", max_abs_err=err, tolerance=0,
                   ms=device_ms(lambda: dk.dd_max_rows2_cuda(mt, st),
                                label=f"dd {label} both sides",
                                kernel="dd_max_rows"),
                   call_ms=timed(lambda: dk.dd_max_rows2_cuda(mt, st)),
                   plain_ms=device_ms(lambda: ref.dd_max_rows2_ref(mt, st),
                                      iters=1,
                                      label=f"plain dd {label} both sides"),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   pairs=pairs,
                   **graph_cols(lambda: dk.dd_max_rows2_cuda(mt, st)))
        details.append(row)
        # the kernels line reads the launch the generator makes
        rows.setdefault("dd_max_rows", row)
        for side, (g, h) in (("a_lo", (mt, st)), ("a_hi", (-st, -mt))):
            got = dk.dd_max_rows_cuda(g, h)
            want = ref.dd_max_rows_ref(g, h)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            same = torch.equal(got, want)
            n_rows, t = g.shape
            print(f"dd_max_rows {label} {side} ({n_rows}, {t}): bitwise "
                  f"equal {same}, max_abs_err {err} (tolerance 0, bitwise)")
            if not same:
                raise AssertionError(f"dd_max_rows {label} differs from plain")
            pairs = n_rows * t * (t - 1) // 2
            b_ms, b_by = bound(4 * (2 * n_rows * t + n_rows), 3 * pairs,
                               F32_FLOPS)
            row = dict(name="dd_max_rows", shape=[n_rows, t],
                       case=f"{label} {side}", max_abs_err=err, tolerance=0,
                       ms=device_ms(lambda: dk.dd_max_rows_cuda(g, h),
                                    label=f"dd {label} {side}",
                                    kernel="dd_max_rows"),
                       call_ms=timed(lambda: dk.dd_max_rows_cuda(g, h)),
                       plain_ms=device_ms(lambda: ref.dd_max_rows_ref(g, h),
                                          iters=1,
                                          label=f"plain dd {label} {side}"),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       pairs=pairs,
                       **graph_cols(lambda: dk.dd_max_rows_cuda(g, h)))
            details.append(row)
    # the one-row kernel through its public drop-in, against the plain one
    L, U = recip.region_bounds(5)
    got = ops.envelopes_pallas(L[0], U[0], device=dev)
    want = ops.envelopes_pallas(L[0], U[0], device="cpu")
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("envelopes_pallas on the card differs from the "
                             "CPU plain version")
    print("envelopes_pallas recip16 R=5 region 0: card == CPU plain version, "
          "bitwise")
    return rows, details


def generator_phase(dev) -> dict:
    """The generator through its entry points on the card (the main path
    of this slice); launch counts are read right after it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Explorer, ExploreConfig, get_spec
    from repro_torch.api.library import DEFAULT_LIBRARY_KINDS
    from repro_torch.core import designspace
    from repro_torch.kernels import build
    from repro_torch.kernels.dspace.ops import envelopes_pallas
    from repro_torch.kernels.interp.ops import table_eval

    out = {"table1": []}
    libs = {}

    def explore(spec, **kw):
        with tempfile.TemporaryDirectory() as d:
            ex = Explorer(ExploreConfig(cache_dir=d, device=str(dev), **kw))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ex.explore(spec)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

    build.reset_launches()
    t_phase = time.perf_counter()
    for kind, kw in TABLE1_16:
        spec = get_spec(kind, 16, **kw)
        exact, t_exact = explore(spec)
        dev_res, t_dev = explore(spec, engine="pallas")
        best, best_x = dev_res.best.design, exact.best.design
        ok, worst = best.verify(spec)
        codes = torch.arange(1 << spec.in_bits, dtype=torch.int32,
                             device=dev)
        on_card = table_eval(codes, best).cpu().numpy().astype(np.int64)
        eval_ok = bool(np.array_equal(
            on_card, best.eval_int(np.arange(1 << spec.in_bits))))
        same = best.to_dict() == best_x.to_dict()
        diff = None
        if not same:  # which R and verdict moved
            diff = {"exact": [(e.design.lookup_bits, e.design.k)
                              for e in exact.entries],
                    "pallas": [(e.design.lookup_bits, e.design.k)
                               for e in dev_res.entries]}
        rec = dict(spec=spec.name, min_regions_exact=exact.min_regions_r,
                   min_regions_pallas=dev_res.min_regions_r,
                   wall_s_exact=t_exact, wall_s_pallas=t_dev,
                   best=best.name, lookup_bits=best.lookup_bits,
                   degree=best.degree, k=best.k, fits_int32=best.fits_int32,
                   verify=ok, worst=worst, table_eval_bit_exact=eval_ok,
                   identical_to_exact=same, difference=diff)
        print(f"{spec.name}: min_regions pallas {dev_res.min_regions_r} / "
              f"exact {exact.min_regions_r}; best {best.name} (R "
              f"{best.lookup_bits}, degree {best.degree}, k {best.k}, "
              f"fits_int32 {best.fits_int32}); verify over {1 << 16} codes "
              f"{ok}; table_eval on the card == eval_int {eval_ok}; "
              f"identical to the exact engine's design {same}; wall "
              f"{t_dev:.2f} s pallas engine / {t_exact:.2f} s exact engine")
        if (dev_res.min_regions_r != exact.min_regions_r or not ok
                or not eval_ok):
            raise AssertionError(f"{spec.name}: the pallas engine on the "
                                 f"card disagrees: {rec}")
        out["table1"].append(rec)
        if kind == "recip":
            # the one-row drop-in for core.designspace.envelopes, on each
            # region at the minimum R: same Eqn 9 verdicts as the exact
            # numpy envelopes
            L, U = spec.region_bounds(dev_res.min_regions_r)
            for r in range(L.shape[0]):
                big, m = envelopes_pallas(L[r], U[r], device=dev)
                big_x, m_x = designspace.envelopes(L[r], U[r])
                if not np.array_equal(big[1:] < m[1:], big_x[1:] < m_x[1:]):
                    raise AssertionError(f"envelopes_pallas region {r}: "
                                         f"Eqn 9 verdicts differ")
            print(f"envelopes_pallas on recip16's {L.shape[0]} regions at R "
                  f"{dev_res.min_regions_r}: Eqn 9 verdicts equal the exact "
                  f"numpy envelopes'")
    for label, kw in (("fleet device path, mesh=2", {"mesh": 2}),
                      ("engine=pallas", {"engine": "pallas"})):
        with tempfile.TemporaryDirectory() as d:
            ex = Explorer(ExploreConfig(cache_dir=d, device=str(dev), **kw))
            t0 = time.perf_counter()
            lib = ex.compile()
            torch.cuda.synchronize()
            t_c = time.perf_counter() - t0
            sha = lib.rom_sha()
            codes = torch.arange(4096, dtype=torch.int32, device=dev)
            evals, designs = {}, {}
            for kind in DEFAULT_LIBRARY_KINDS:
                design = designs[kind] = ex.get_table(kind)
                got = table_eval(codes, design).cpu().numpy()
                evals[kind] = bool(np.array_equal(
                    got.astype(np.int64), design.eval_int(np.arange(4096))))
        print(f"compile() on the card, {label}: rom_sha {sha} (expected "
              f"{DEFAULT_ROM_SHA}) in {t_c:.2f} s; interp_eval over 4096 "
              f"codes == eval_int for {sum(evals.values())}/{len(evals)} "
              f"tables")
        if sha != DEFAULT_ROM_SHA or not all(evals.values()):
            raise AssertionError(f"compile() {label}: sha {sha}, {evals}")
        libs[label] = lib, designs
        out[f"compile {label}"] = dict(rom_sha=sha, wall_s=t_c,
                                       interp_eval_equal=evals)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = {k: build.LAUNCHES[k]
                       for k in ("interp_eval", *ENVELOPE_KERNELS)}
    print(f"generator phase: {out['wall_s']:.1f} s; launches "
          f"{out['launches']}")
    check_front_half_launches(out["launches"], "generator phase")

    # where the pallas engine's time goes: a profiled rerun of recip16
    spec = get_spec("recip", 16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t_prof = explore(spec, engine="pallas")
    kern, total = 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += _dev_us(e)
            if "envelopes_parity_kernel" in e.key or "dd_max_rows" in e.key:
                kern += _dev_us(e)
    out["recip16_pallas_split"] = dict(
        profiled_wall_s=t_prof, envelope_kernels_device_s=kern / 1e6,
        all_device_s=total / 1e6)
    print(f"recip16 pallas engine, profiled rerun: {t_prof:.2f} s wall, "
          f"{kern / 1e6:.4f} s device time in the envelope kernels, "
          f"{total / 1e6:.4f} s device time in all; the rest is the host "
          f"(bounds, the §III decision procedure in numpy, transfers)")
    out["recip16_pallas_host"] = host_profile(lambda: explore(
        spec, engine="pallas"))
    out["library"], out["designs"] = libs["engine=pallas"]
    return out


def check_front_half_launches(launches: dict, label: str) -> None:
    """Each §II front-half call (``_merge_reduce``) launches one envelope
    kernel over its region batch or fleet and one two-sided
    ``dd_max_rows``: the counts must match."""
    fronts = (launches["envelopes_parity_batched"]
              + launches["envelopes_parity_fleet"])
    print(f"{label}: {launches['dd_max_rows']} dd_max_rows launches for "
          f"{fronts} batched / fleet envelope launches (one two-sided "
          f"launch per region batch)")
    if launches["dd_max_rows"] != fronts:
        raise AssertionError(f"{label}: dd_max_rows launched "
                             f"{launches['dd_max_rows']} times for {fronts} "
                             f"front halves")


def host_profile(fn, top: int = 5) -> dict:
    """``fn()`` under cProfile: its wall seconds and the ``top`` functions
    of the §III modules (``core/decision.py``, ``core/batched.py``,
    ``core/fleet.py``) by cumulative time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    mods = ("decision.py", "batched.py", "fleet.py")
    rows = []
    for (path, line, func), (_cc, calls, tot, cum, _) in stats.stats.items():
        p = pathlib.PurePath(path)
        if p.name in mods and p.parent.name == "core" and \
                "repro_torch" in p.parts:
            rows.append(dict(function=f"core/{p.name}:{line} {func}",
                             calls=calls, cumulative_s=cum, own_s=tot))
    rows.sort(key=lambda r: -r["cumulative_s"])
    print(f"recip16 pallas engine under cProfile: {wall:.2f} s wall; the "
          f"§III functions with the most cumulative time:")
    for r in rows[:top]:
        print(f"  {r['function']}: {r['cumulative_s']:.3f} s cumulative, "
              f"{r['own_s']:.3f} s own, {r['calls']} calls")
    return dict(wall_s=wall, top=rows[:top])


def segmented_generator_phase(dev) -> dict:
    """compile_segmented() of the default manifest on the card (the main
    path of this slice); launch counts are read right after it. Returns the
    segmented library and each kind's design (the int64 oracle)."""
    import torch

    from repro_torch.api import Explorer, ExploreConfig, spec_for
    from repro_torch.api.library import DEFAULT_LIBRARY_KINDS, InterpLibrary
    from repro_torch.kernels import build
    from repro_torch.kernels.interp.ops import rom_eval
    from repro_torch.segment import explore_segmented

    def compile_seg(**kw):
        with tempfile.TemporaryDirectory() as d:
            ex = Explorer(ExploreConfig(cache_dir=d, device=str(dev), **kw))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lib = ex.compile_segmented()
            torch.cuda.synchronize()
            return lib, time.perf_counter() - t0, ex

    build.reset_launches()
    t_phase = time.perf_counter()
    lib, t_pallas, _ = compile_seg(engine="pallas")
    sha = lib.rom_sha()
    rows = sum(m.rows_used for m in lib.metas)
    shapes = {m.kind: (m.seg_depth, len(m.seg_meta), m.rows_used)
              for m in lib.metas}
    print(f"compile_segmented() on the card, engine=pallas: rom_sha {sha} "
          f"(expected {SEG_ROM_SHA}), {tuple(lib.coeffs.shape)}, {rows} rows "
          f"used, manifest v{lib.manifest()['version']}, in {t_pallas:.2f} s;"
          f" (depth, leaves, rows) per kind {shapes}")
    if (sha != SEG_ROM_SHA or tuple(lib.coeffs.shape) != SEG_ROM_SHAPE
            or rows != SEG_ROWS or lib.manifest()["version"] != 2):
        raise AssertionError(f"compile_segmented under engine=pallas: {sha}")
    # the same call under the exact engine on the same host
    lib_x, t_exact, ex = compile_seg()
    same = {}
    for m, mx in zip(lib.metas, lib_x.metas):
        f = lib.func_id(m.kind)
        same[m.kind] = bool(m == mx and torch.equal(lib.coeffs[f],
                                                    lib_x.coeffs[f]))
    print(f"compile_segmented() under the exact engine on the same host: "
          f"rom_sha {lib_x.rom_sha()} in {t_exact:.2f} s; the pallas "
          f"engine's slot equals the exact engine's for "
          f"{sum(same.values())}/{len(same)} kinds")
    if lib_x.rom_sha() != SEG_ROM_SHA:
        raise AssertionError(f"exact engine: {lib_x.rom_sha()}")
    # each kind's design from the exact engine's segmenter, and every slot
    # of the card's library through the in-kernel read against its eval_int
    designs, rom_equal = {}, {}
    with tempfile.TemporaryDirectory() as d:
        ex = Explorer(ExploreConfig(cache_dir=d, device=str(dev)))
        for kind in DEFAULT_LIBRARY_KINDS:
            designs[kind] = explore_segmented(
                spec_for(kind), max_depth=ex.get_table(kind).lookup_bits,
                engine="batched", device=dev)
    for kind, design in designs.items():
        codes = torch.arange(1 << design.in_bits, dtype=torch.int32,
                             device=dev)
        got = rom_eval(codes, lib, kind).cpu().numpy().astype(np.int64)
        rom_equal[kind] = bool(np.array_equal(
            got, design.eval_int(np.arange(1 << design.in_bits))))
    print(f"rom_eval on every slot of the card's segmented library == the "
          f"design's eval_int for {sum(rom_equal.values())}/"
          f"{len(rom_equal)} kinds (4096 codes each)")
    if not all(rom_equal.values()):
        raise AssertionError(f"rom_eval differs from eval_int: {rom_equal}")
    # the v2 artifact survives save and load
    with tempfile.TemporaryDirectory() as d:
        back = InterpLibrary.load(lib.save(pathlib.Path(d) / "seg"),
                                  device=dev)
    if back.rom_sha() != sha or back.metas != lib.metas:
        raise AssertionError("the saved v2 library did not load back")
    print(f"saved and loaded the v2 library: rom_sha {back.rom_sha()}")
    torch.cuda.synchronize()
    out = dict(rom_sha=sha, shape=list(lib.coeffs.shape), rows_used=rows,
               per_kind=shapes, wall_s_pallas=t_pallas, wall_s_exact=t_exact,
               pallas_equals_exact=same, rom_eval_equals_eval_int=rom_equal,
               wall_s=time.perf_counter() - t_phase,
               launches={k: build.LAUNCHES[k]
                         for k in ("rom_eval", *ENVELOPE_KERNELS)})
    print(f"segmented generator phase: {out['wall_s']:.1f} s; launches "
          f"{out['launches']}")
    check_front_half_launches(out["launches"], "segmented generator phase")
    return out, lib, designs


def walk_phase(seg_lib, seg_designs, uni_lib, uni_designs, dev, silu_codes):
    """library_walk and rom_eval against their plain versions and the
    designs' eval_int on both libraries, bitwise, and timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.interp.ops import (library_eval, library_walk,
                                                rom_eval)
    from repro_torch.kernels.interp.ref import library_walk_ref, rom_eval_ref

    rows, details = {}, []
    flush = l2_flush(dev)
    for label, lib, designs in (("segmented", seg_lib, seg_designs),
                                ("uniform", uni_lib, uni_designs)):
        walk, dp = lib.walk_rows()
        codes = torch.arange(4096, dtype=torch.int32, device=dev).repeat(
            len(lib))
        fids = torch.arange(len(lib), dtype=torch.int32,
                            device=dev).repeat_interleave(4096)
        got = library_walk(codes, fids, lib.coeffs, walk, dp)
        plain = library_walk_ref(codes, fids, lib.coeffs, walk, dp)
        oracle = np.concatenate([designs[k].eval_int(np.arange(4096))
                                 for k in lib.kinds])
        torch.cuda.synchronize()
        ok = (torch.equal(got, plain) and np.array_equal(
            got.cpu().numpy().astype(np.int64), oracle))
        if label == "uniform":
            ok = ok and torch.equal(got, library_eval(codes, fids, lib.coeffs,
                                                      lib.meta_rows()))
        roms = []
        for kind in lib.kinds:
            c = codes[:4096]
            m = lib.meta(kind)
            r = rom_eval(c, lib, kind)
            r_plain = rom_eval_ref(c, lib.coeffs.reshape(-1, 3),
                                   fid=lib.func_id(kind), r_max=lib.r_max,
                                   eval_bits=m.eval_bits, k=m.k,
                                   sq_trunc=m.sq_trunc, lin_trunc=m.lin_trunc,
                                   degree=m.degree, seg=m.seg_spec())
            roms.append(torch.equal(r, r_plain) and np.array_equal(
                r.cpu().numpy().astype(np.int64),
                designs[kind].eval_int(np.arange(4096))))
        print(f"library_walk over every code of every kind of the {label} "
              f"library ({len(lib)} x 4096): == plain version and eval_int "
              f"{ok}{' and == library_eval' if label == 'uniform' else ''}; "
              f"rom_eval == plain version and eval_int for {sum(roms)}/"
              f"{len(roms)} slots (tolerance 0, bitwise)")
        if not ok or not all(roms):
            raise AssertionError(f"library_walk / rom_eval on the {label} "
                                 f"library differ")

    # the segmented library at every shape the served models hand the
    # walk, one id as the engine calls it
    lib = seg_lib
    walk, dp = lib.walk_rows()
    g = torch.Generator(device=dev).manual_seed(4321)
    silu = lib.func_id("silu")
    for shape in act_shapes():
        gate = (torch.randn(shape, device=dev, generator=g) * 3
                ).to(torch.bfloat16)
        codes = silu_codes(gate)
        got = library_walk(codes, silu, lib.coeffs, walk, dp)
        want = library_walk_ref(codes, torch.full_like(codes, silu),
                                lib.coeffs, walk, dp)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"library_walk {shape} silu, segmented library: bitwise equal "
              f"to the plain version {same} (tolerance 0)")
        if not same:
            raise AssertionError(f"library_walk {shape} differs from plain")

    # timing on the segmented library: Yi-6B's silu codes (one id) and a
    # large mixed shape (one id per element)
    table_bytes = 4 * (lib.coeffs.numel() + walk.numel() + dp.numel())
    for shape, mixed in (((4, 1, 11008), False), ((1, 512, 11008), True)):
        gate = (torch.randn(shape, device=dev, generator=g) * 3
                ).to(torch.bfloat16)
        codes = silu_codes(gate)
        fids = (torch.randint(0, len(lib), shape, dtype=torch.int32,
                              device=dev, generator=g) if mixed
                else torch.full_like(codes, silu))
        if mixed:  # in-range codes for every function of the mix
            codes = codes & 4095
        arg = fids if mixed else silu
        got = library_walk(codes, arg, lib.coeffs, walk, dp)
        want = library_walk_ref(codes, fids, lib.coeffs, walk, dp)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        print(f"library_walk {shape} {'per-element ids' if mixed else 'silu'}"
              f": max_abs_err {err} (tolerance 0, bit-exact)")
        if err:
            raise AssertionError(f"library_walk {shape} differs from plain")
        n = codes.numel()
        b_ms, b_by = bound((12 if mixed else 8) * n + table_bytes, 14 * n,
                           F32_FLOPS)
        row = dict(name="library_walk", shape=list(shape), library="segmented",
                   ids="per element" if mixed else "one", max_abs_err=err,
                   tolerance=0,
                   ms=device_ms(lambda: library_walk(codes, arg, lib.coeffs,
                                                     walk, dp),
                                label=f"walk {shape}",
                                kernel="library_walk"),
                   call_ms=timed(lambda: library_walk(codes, arg, lib.coeffs,
                                                      walk, dp)),
                   plain_ms=device_ms(lambda: library_walk_ref(
                       codes, fids, lib.coeffs, walk, dp), iters=3,
                       label=f"plain walk {shape}"),
                   library_ms=device_ms(lambda: F.silu(gate),
                                        label=f"silu {shape}"),
                   bound_ms=b_ms, bound_by=b_by,
                   **graph_cols(lambda: library_walk(codes, arg, lib.coeffs,
                                                     walk, dp),
                                lambda: F.silu(gate)))
        if mixed:  # the same with a cold L2
            row["cold_ms"] = device_ms(
                lambda: (flush(), library_walk(codes, arg, lib.coeffs, walk,
                                               dp)),
                label=f"cold walk {shape}", kernel="library_walk", own=True)
        details.append(row)
        rows.setdefault("library_walk", row)
    # rom_eval: the silu slot at the same two shapes, on both libraries
    for label, lib in (("segmented", seg_lib), ("uniform", uni_lib)):
        m = lib.meta("silu")
        rom_args = dict(fid=lib.func_id("silu"), r_max=lib.r_max,
                        eval_bits=m.eval_bits, k=m.k, sq_trunc=m.sq_trunc,
                        lin_trunc=m.lin_trunc, degree=m.degree,
                        seg=m.seg_spec())
        flat = lib.coeffs.reshape(-1, 3)
        for shape in ((4, 1, 11008), (1, 512, 11008)):
            gate = (torch.randn(shape, device=dev, generator=g) * 3
                    ).to(torch.bfloat16)
            codes = silu_codes(gate)
            got = rom_eval(codes, lib, "silu")
            err = int((got - rom_eval_ref(codes, flat, **rom_args)
                       ).abs().max())
            if err:
                raise AssertionError(f"rom_eval {shape} on the {label} "
                                     f"library differs from plain")
            n = codes.numel()
            b_ms, b_by = bound(8 * n + 12 * lib.r_max + 20 * len(m.seg_meta),
                               14 * n, F32_FLOPS)
            row = dict(name="rom_eval", shape=list(shape), library=label,
                       case="silu", max_abs_err=err, tolerance=0,
                       ms=device_ms(lambda: rom_eval(codes, lib, "silu"),
                                    label=f"rom_eval {shape} {label}",
                                    kernel="rom_eval"),
                       call_ms=timed(lambda: rom_eval(codes, lib, "silu")),
                       plain_ms=device_ms(lambda: rom_eval_ref(
                           codes, flat, **rom_args), iters=3,
                           label=f"plain rom_eval {shape} {label}"),
                       library_ms=device_ms(lambda: F.silu(gate),
                                            label=f"silu {shape}"),
                       bound_ms=b_ms, bound_by=b_by,
                       **graph_cols(lambda: rom_eval(codes, lib, "silu"),
                                    lambda: F.silu(gate)))
            if shape[1] > 1:  # the same with a cold L2
                row["cold_ms"] = device_ms(
                    lambda: (flush(), rom_eval(codes, lib, "silu")),
                    label=f"cold rom_eval {shape} {label}",
                    kernel="rom_eval", own=True)
            details.append(row)
            rows.setdefault("rom_eval", row)
    for r in details:
        print(f"  device time {r['name']} {r['shape']} {r['library']}: "
              f"kernel {r['ms']:.5f} "
              f"ms (graph {_ms(r['graph_ms'])}), plain {r['plain_ms']:.5f} "
              f"ms, library {r['library_ms']:.5f} ms (graph "
              f"{_ms(r['library_graph_ms'])}), bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}); back-to-back call {r['call_ms']:.5f} ms"
              + (f"; cold L2 {r['cold_ms']:.5f} ms" if "cold_ms" in r
                 else ""))
    return rows, details


def interp_eval_phase(lib_designs, dev, silu_codes):
    """interp_eval against its plain version on every table of the
    generated library, all 4096 codes, and on the silu design at Yi-6B's
    prefill width (the unbound ``InterpNumerics`` activation), warm and
    with a cold L2."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.interp.kernel import interp_eval_cuda
    from repro_torch.kernels.interp.ref import interp_eval_ref

    details = []
    flush = l2_flush(dev)
    g = torch.Generator(device=dev).manual_seed(2020)
    gate = (torch.randn(1, 512, 11008, device=dev, generator=g) * 3
            ).to(torch.bfloat16)
    cases = [(kind, torch.arange(1 << d.in_bits, dtype=torch.int32,
                                 device=dev))
             for kind, d in lib_designs.items()]
    cases.append(("silu", silu_codes(gate)))
    for kind, codes in cases:
        design = lib_designs[kind]
        coeffs = design.device_coeffs(dev)
        dp = dict(eval_bits=design.eval_bits, k=design.k,
                  sq_trunc=design.sq_trunc, lin_trunc=design.lin_trunc,
                  degree=design.degree)
        got = interp_eval_cuda(codes, coeffs, **dp)
        want = interp_eval_ref(codes, coeffs, **dp)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"interp_eval {kind} {tuple(codes.shape)} "
                                 f"differs from plain")
        n = codes.numel()
        wide = codes.dim() > 1
        # the yardstick: recip's decoded input, or the gate the codes
        # quantize
        x = gate if wide else 1.0 + codes.float() / n
        yard = (lambda: F.silu(x)) if wide else (lambda: torch.reciprocal(x))
        b_ms, b_by = bound(8 * n + coeffs.numel() * 4, 12 * n, F32_FLOPS)
        row = dict(
            name="interp_eval", shape=list(codes.shape), case=kind,
            max_abs_err=err, tolerance=0,
            ms=device_ms(lambda: interp_eval_cuda(codes, coeffs, **dp),
                         label=f"interp_eval {kind} {tuple(codes.shape)}",
                         kernel="interp_eval"),
            call_ms=timed(lambda: interp_eval_cuda(codes, coeffs, **dp)),
            plain_ms=device_ms(lambda: interp_eval_ref(codes, coeffs, **dp),
                               iters=3, label=f"plain interp_eval {kind}"),
            library_ms=device_ms(yard, label=f"yardstick {kind}"),
            bound_ms=b_ms, bound_by=b_by,
            **graph_cols(lambda: interp_eval_cuda(codes, coeffs, **dp),
                         yard))
        if wide:
            row["cold_ms"] = device_ms(
                lambda: (flush(), interp_eval_cuda(codes, coeffs, **dp)),
                label=f"cold interp_eval {kind}", kernel="interp_eval",
                own=True)
        details.append(row)
    print(f"interp_eval on all 4096 codes of {len(lib_designs)} generated "
          f"tables and on (1, 512, 11008) silu codes: max_abs_err 0 against "
          f"the plain version (tolerance 0)")
    for r in (details[[r['case'] for r in details].index('recip')],
              details[-1]):
        print(f"  device time interp_eval {r['case']} {r['shape']}: kernel "
              f"{r['ms']:.5f} ms (graph {_ms(r['graph_ms'])}), yardstick "
              f"graph {_ms(r['library_graph_ms'])}, bound {r['bound_ms']:.5f}"
              f" ms" + (f"; cold L2 {r['cold_ms']:.5f} ms" if "cold_ms" in r
                        else ""))
    rec = next(r for r in details if r["case"] == "recip")
    return rec, details


def kernel_phases(lib, dev, silu_codes, label="uniform"):
    """Each kernel against its plain version on ``lib``, timed; returns rows
    for the kernels line and details. On a segmented library the
    activations take ``library_walk`` (``walk_phase``), so ``library_eval``
    runs on the uniform one only."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flashattn.kernel import kv_splits, query_tile
    from repro_torch.kernels.flashattn.ops import attention_fused_library
    from repro_torch.kernels.flashattn.ref import attention_fused_library_ref
    from repro_torch.kernels.interp.ops import library_eval
    from repro_torch.kernels.interp.ref import library_eval_ref
    from repro_torch.numerics.ops import softmax_ulp_bound

    g = torch.Generator(device=dev).manual_seed(1234)
    rows, details = {}, []
    flush = l2_flush(dev)

    # -- library_eval: the SwiGLU silu codes at the served shapes ----------
    silu = lib.func_id("silu")
    meta = lib.meta_rows()
    for shape in act_shapes() if not lib.segmented_kinds else ():
        gate = (torch.randn(shape, device=dev, generator=g) * 3
                ).to(torch.bfloat16)
        codes = silu_codes(gate)
        fids = torch.full_like(codes, silu)
        got = library_eval(codes, silu, lib.coeffs, meta)
        want = library_eval_ref(codes, fids, lib.coeffs, meta)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        print(f"library_eval {shape}: max_abs_err {err} (tolerance 0, "
              f"bit-exact)")
        if err:
            raise AssertionError(f"library_eval {shape} differs from plain")
        n = codes.numel()
        b_ms, b_by = bound(8 * n + 4 + lib.coeffs.numel() * 4 + meta.numel() * 4,
                           12 * n, F32_FLOPS)
        row = dict(name="library_eval", shape=list(shape), max_abs_err=err,
                   tolerance=0,
                   ms=device_ms(lambda: library_eval(codes, silu, lib.coeffs,
                                                     meta),
                                label=f"{label} {shape}",
                                kernel="library_eval"),
                   call_ms=timed(lambda: library_eval(codes, silu, lib.coeffs,
                                                      meta)),
                   plain_ms=device_ms(lambda: library_eval_ref(
                       codes, fids, lib.coeffs, meta), iters=3,
                       label=f"{label} plain {shape}"),
                   library_ms=device_ms(lambda: F.silu(gate),
                                        label=f"{label} silu {shape}"),
                   bound_ms=b_ms, bound_by=b_by,
                   **graph_cols(lambda: library_eval(codes, silu, lib.coeffs,
                                                     meta),
                                lambda: F.silu(gate)))
        if shape == (1, 512, 11008):  # the same with a cold L2
            row["cold_ms"] = device_ms(
                lambda: (flush(), library_eval(codes, silu, lib.coeffs,
                                               meta)),
                label=f"{label} cold {shape}", kernel="library_eval",
                own=True)
        details.append(row)
        rows.setdefault("library_eval", row)

    # -- rmsnorm_lib -------------------------------------------------------
    for row in rmsnorm_lib_rows(lib, dev, g, flush, label):
        details.append(row)
        rows.setdefault("rmsnorm_lib", row)

    # -- flash_attn_lib ----------------------------------------------------
    sm_bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    d = 128
    # Yi-6B: 32 query heads over 4 KV heads; DeepSeekMoE: 16 over 16 (g = 1);
    # in bf16 (the tensor-core body) and, at Yi-6B's shapes, in float32 (the
    # CUDA-core body)
    cases = [(hk, m, torch.bfloat16) for hk in ((32, 4), (16, 16))
             for m in ("decode", "prefill")]
    cases += [((32, 4), m, torch.float32) for m in ("decode", "prefill")]
    for (h, kvh), mode, dtype in cases:
        bf = dict(device=dev, dtype=dtype)
        if mode == "decode":  # 4 slots against a 1024-row cache, dead rows
            b, sq, sk = 4, 1, 1024
            kc = torch.randn(b, kvh, sk, d, generator=g, **bf)
            vc = torch.randn(b, kvh, sk, d, generator=g, **bf)
            k, v = kc.transpose(1, 2), vc.transpose(1, 2)
            lens = torch.tensor([17, 300, 1000, 600], device=dev)
            kv_pos = torch.arange(sk, device=dev).expand(b, sk).clone()
            kv_pos[kv_pos >= lens[:, None]] = -1
            q_pos = (lens - 1)[:, None]
        else:  # causal prefill of one 512-token prompt
            b, sq, sk = 1, 512, 512
            k = torch.randn(b, sk, kvh, d, generator=g, **bf)
            v = torch.randn(b, sk, kvh, d, generator=g, **bf)
            kv_pos = torch.arange(sk, device=dev).expand(b, sk)
            q_pos = kv_pos
        q = torch.randn(b, sq, h, d, generator=g, **bf)
        q_pos, kv_pos = q_pos.to(torch.int32), kv_pos.to(torch.int32)
        kw = dict(q_pos=q_pos, kv_pos=kv_pos)
        got = attention_fused_library(q, k, v, lib, **kw).float()
        want = attention_fused_library_ref(q, k, v, lib, **kw).float()
        torch.cuda.synchronize()
        vmax = float(v.float().abs().max())
        n_tiles = (sk + 63) // 64
        tol_abs = (n_tiles + 2) * sm_bound * vmax
        excess = float(((got - want).abs() - tol_abs
                        - 2.0 ** -7 * (vmax + want.abs())).max())
        err = float((got - want).abs().max())
        print(f"flash_attn_lib {mode} {str(dtype)[6:]} B={b} H={h} KVH={kvh} "
              f"D={d} Sq={sq} Sk={sk}: max_abs_err {err:.3e} (tolerance "
              f"{tol_abs:.3e} = "
              f"({n_tiles} tiles + 2) x softmax_ulp_bound {sm_bound:.3e} x "
              f"max|v|, + 2^-7 (max|v| + |out|) bf16 roundings)")
        if excess > 0:
            raise AssertionError(f"flash_attn_lib {mode} differs from plain")
        tq = query_tile(sq, h // kvh, d)
        splits = kv_splits(b, kvh, -(-sq // tq), sk)
        twin = attention_fused_library_ref(q, k, v, lib, block_k=64,
                                           block_q=tq, kv_splits=splits,
                                           **kw).float()
        terr = (got - twin).abs()
        t_excess = float((terr - sm_bound * vmax - 2.0 ** -8 * twin.abs()
                          ).max())
        print(f"  against the tile-by-tile twin (64-key tiles, {tq}-query "
              f"tiles, {splits} key splits): max_abs_err "
              f"{float(terr.max()):.3e}, mean {float(terr.mean()):.3e} "
              f"(tolerance {sm_bound * vmax:.3e} = one table-code flip, + "
              f"2^-8 |out| one bf16 rounding)")
        if t_excess > 0:
            raise AssertionError(f"flash_attn_lib {mode} differs from the "
                                 f"tile-by-tile twin")
        # the work this data needs: live (query, key) pairs per head
        live = ((kv_pos[:, None, :] >= 0)
                & (kv_pos[:, None, :] <= q_pos[:, :, None]))
        pairs = int(live.sum())
        live_rows = int(((kv_pos >= 0) & (kv_pos <= q_pos.max(-1, keepdim=True)
                                          .values)).sum())
        es = q.element_size()
        nbytes = (q.numel() * es + 2 * live_rows * kvh * d * es
                  + kv_pos.numel() * 4 + q_pos.numel() * 4 + q.numel() * es)
        b_ms, b_by = bound(nbytes, 4 * d * h * pairs,
                           BF16_FLOPS if dtype == torch.bfloat16
                           else F32_FLOPS)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if mode == "decode":
            mask = live[:, None]

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, mask,
                                                      enable_gqa=True)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      enable_gqa=True)
        row = dict(name="flash_attn_lib", shape=[b, sq, h, kvh, d, sk],
                   mode=mode, dtype=str(dtype)[6:], max_abs_err=err,
                   tolerance=tol_abs,
                   ms=device_ms(lambda: attention_fused_library(q, k, v, lib,
                                                                **kw),
                                label=f"{label} flash {mode} H={h}",
                                kernel="flash_attn_lib"),
                   call_ms=timed(lambda: attention_fused_library(q, k, v,
                                                                 lib, **kw)),
                   plain_ms=device_ms(lambda: attention_fused_library_ref(
                       q, k, v, lib, **kw), iters=3,
                       label=f"{label} plain flash {mode} H={h}"),
                   library_ms=device_ms(sdpa,
                                        label=f"{label} sdpa {mode} H={h}"),
                   bound_ms=b_ms, bound_by=b_by, kv_splits=splits,
                   **graph_cols(lambda: attention_fused_library(q, k, v, lib,
                                                                **kw),
                                sdpa))
        details.append(row)
        rows.setdefault("flash_attn_lib", row)

    # -- softmax_lib -------------------------------------------------------
    for row in softmax_lib_rows(lib, dev, g, flush, label):
        details.append(row)
        rows.setdefault("softmax_lib", row)
    for r in details:
        r["library"] = label
        print(f"  device time {r['name']} {r['shape']}"
              f"{' ' + r['dtype'] if r.get('dtype') else ''} ({label} library): "
              f"kernel {r['ms']:.5f} ms (graph {_ms(r['graph_ms'])}), plain "
              f"{r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms "
              f"(graph {_ms(r['library_graph_ms'])}), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}); back-to-back call "
              f"{r['call_ms']:.5f} ms"
              + (f"; cold L2 {r['cold_ms']:.5f} ms" if "cold_ms" in r
                 else ""))
    return rows, details


# softmax_lib's shapes: DeepSeekMoE's router at decode (4 slots) and in
# the 511-token prefill (64 experts, float32), a wide bf16 row, and the
# per-table phase's two large calls (the same body): ragged bf16 rows and a
# 512-token prefill's scores over 32 heads
SOFTMAX_SHAPES = (((4, 64), "float32"), ((511, 64), "float32"),
                  ((8, 4096), "bfloat16"), ((37, 1000), "bfloat16"),
                  ((16384, 512), "float32"))
SOFTMAX_TPRS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def softmax_lib_rows(lib, dev, g, flush, label):
    """softmax_lib at ``SOFTMAX_SHAPES`` on ``lib``: e bitwise against the
    plain version's, the output bitwise against the twin with the kernels'
    sum order (``kernel_order_softmax``) for both bodies and within one
    recip-table step (+ one bf16 rounding) of the plain version; the served
    router call (``FusedInterpNumerics.softmax`` on (1, 4, 64) logits) one
    launch and one device op. Timed beside ``torch.softmax`` on the same
    tensor: both bodies forced (``body_graph_ms``), the float table of
    exp2neg outputs forced on and off (``lut_graph_ms``), every thread
    count per row the wrapper takes (``tpr_graph_ms``) and, at (16384,
    512), a cold L2 (``cold_ms``, ``library_cold_ms``)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.softmax.kernel import (launch_shape,
                                                    softmax_lib_cuda,
                                                    vector_ok)
    from repro_torch.kernels.softmax.ops import (approx_softmax_library,
                                                 lib_meta)
    from repro_torch.kernels.softmax.ref import (approx_softmax_library_ref,
                                                 kernel_order_softmax,
                                                 softmax_exp)
    from repro_torch.numerics.ops import FusedInterpNumerics

    rb = lib.meta("recip").in_bits
    em, rm = lib_meta(lib, "exp2neg"), lib_meta(lib, "recip")
    out = []
    for shape, dname in SOFTMAX_SHAPES:
        dtype = getattr(torch, dname)
        x = (torch.randn(shape, device=dev, generator=g) * 4).to(dtype)
        n_rows, d = shape
        es = x.element_size()
        want = approx_softmax_library_ref(x, lib)
        _, e_ref = softmax_exp(x, lib.coeffs, em)
        tol = 2.0 ** -(rb - 1) + (2.0 ** -7 if dtype == torch.bfloat16
                                  else 0.0)
        checks = {}
        for body in ("vector", "masked"):
            got, e = softmax_lib_cuda(x, lib, return_e=True, body=body)
            vector = body == "vector" and vector_ok(x, got)
            _, tpr, _, _ = launch_shape(n_rows, d, es, vector)
            twin = kernel_order_softmax(x, lib.coeffs, lib.coeffs, em, rm,
                                        16 // es if vector else 1, tpr)
            torch.cuda.synchronize()
            e_exact, twin_exact = torch.equal(e, e_ref), torch.equal(got,
                                                                     twin)
            gf, wf = got.float(), want.float()
            err = float((gf - wf).abs().max())
            rel = float(((gf - wf).abs() / wf.abs().clamp_min(1e-30)).max())
            checks[body] = dict(e_bit_exact=e_exact, twin_bitwise=twin_exact,
                                max_abs_err=err, max_rel=rel)
            print(f"softmax_lib {shape} {dname}, {body} body ({label} "
                  f"library): e bit-exact {e_exact}, bitwise the "
                  f"kernel-order twin {twin_exact}, max_abs_err {err:.3e}, "
                  f"max rel {rel:.3e} (tolerance rel {tol:.3e}: one "
                  f"recip-table step 2^-{rb - 1}"
                  f"{' + 1 bf16 rounding' if dtype == torch.bfloat16 else ''})")
            if not (e_exact and twin_exact) or rel > tol:
                raise AssertionError(f"softmax_lib {shape} {body} differs")
        fn = functools.partial(approx_softmax_library, x, lib)
        yard = functools.partial(torch.softmax, x, -1)
        row = dict(name="softmax_lib", shape=list(shape), dtype=dname,
                   library=label, checks=checks,
                   launch=list(launch_shape(n_rows, d, es, vector_ok(
                       x, torch.empty_like(x)))),
                   max_abs_err=checks["vector"]["max_abs_err"],
                   tolerance=tol, e_bit_exact=True)
        if shape == (4, 64):  # the served router call, the model's layout
            num = FusedInterpNumerics(lib)
            x3 = x.reshape(1, 4, 64)
            n0 = dict(build.LAUNCHES)
            served = num.softmax(x3, axis=-1)
            torch.cuda.synchronize()
            launched = {k: v - n0[k] for k, v in build.LAUNCHES.items()
                        if v != n0[k]}
            nodes = graph_ops(lambda: num.softmax(x3, axis=-1))
            same = torch.equal(served.reshape(shape), fn())
            print(f"  router softmax (1, 4, 64) float32 ({label} library): "
                  f"launches {launched}, {nodes} device op(s) (CUDA graph "
                  f"nodes), bitwise the kernel call {same}")
            if launched != {"softmax_lib": 1} or nodes != 1 or not same:
                raise AssertionError("the router softmax is not one "
                                     "softmax_lib launch and one device op")
            row.update(graph_ops=nodes)
        # read x once, write out once, both table slots; ~24 float and
        # integer operations per element (max, t, floor, code, Horner,
        # scale, sum, final scale) at the float32 rate
        b_ms, b_by = bound(2 * x.numel() * es + 2 * lib.r_max * 12,
                           24 * x.numel(), F32_FLOPS)
        tag = f"{label} softmax {shape}"
        row.update(ms=device_ms(fn, label=tag, kernel="softmax_lib"),
                   call_ms=timed(fn),
                   plain_ms=device_ms(functools.partial(
                       approx_softmax_library_ref, x, lib), iters=3,
                       label=f"plain {tag}"),
                   library_ms=device_ms(yard, label=f"torch.softmax {tag}"),
                   bound_ms=b_ms, bound_by=b_by, **graph_cols(fn, yard))
        row["body_graph_ms"] = {body: graph_ms(functools.partial(
            softmax_lib_cuda, x, lib, body=body))[0]
            for body in ("vector", "masked")}
        # the float table of exp2neg outputs forced on and off (bitwise the
        # same outputs: the card tests)
        row["lut_graph_ms"] = {name: graph_ms(functools.partial(
            softmax_lib_cuda, x, lib, lut=on))[0]
            for name, on in (("table", True), ("datapath", False))}
        tprs = {}
        for tpr in SOFTMAX_TPRS:
            try:
                launch_shape(n_rows, d, es, True, tpr)
            except ValueError:
                continue
            tprs[tpr] = graph_ms(functools.partial(softmax_lib_cuda, x, lib,
                                                   tpr=tpr))[0]
        row["tpr_graph_ms"] = tprs
        if shape == (16384, 512):
            row["cold_ms"] = device_ms(lambda: (flush(), fn()),
                                       label=f"cold {tag}",
                                       kernel="softmax_lib", own=True)
            row["library_cold_ms"] = device_ms(
                lambda: (flush(), yard()), label=f"cold torch.softmax {tag}",
                symbol="softmax_warp_forward", own=True)
        print(f"  softmax_lib {shape} {dname} ({label}): graph "
              f"{_ms(row['graph_ms'])} (torch.softmax "
              f"{_ms(row['library_graph_ms'])}), bodies "
              f"{ {k: _ms(v) for k, v in row['body_graph_ms'].items()} }, "
              f"table of outputs "
              f"{ {k: _ms(v) for k, v in row['lut_graph_ms'].items()} }, "
              f"bound {b_ms:.5f} ms; launch {row['launch']}; threads per "
              f"row { {k: _ms(v) for k, v in tprs.items()} }"
              + (f"; cold L2 {row['cold_ms']:.5f} ms (torch.softmax "
                 f"{row['library_cold_ms']:.5f} ms)" if "cold_ms" in row
                 else ""))
        out.append(row)
    return out


# rmsnorm_lib's main-path shapes: Yi-6B (d 4096) and DeepSeekMoE (d 2048)
# at decode (4 slots) and in a prefill (512 and 511 tokens), bf16
RMS_SHAPES = ((4, 4096), (512, 4096), (4, 2048), (511, 2048))
RMS_TPRS = (64, 128, 256, 512, 1024)  # the thread counts per row timed


def rmsnorm_lib_rows(lib, dev, g, flush, label):
    """rmsnorm_lib at ``RMS_SHAPES`` on ``lib``: both bodies and both gamma
    dtypes against the plain version (2 rsqrt-table ulps + one bf16
    rounding; bitwise on two rows whose mean(x^2) is exact in any order),
    the bf16 scale bitwise its float32 cast, and the served call
    (``apply_norm`` with the bf16 scale as stored, the model's layout) one
    launch and one device op. Timed: the served call (bf16 gamma) against
    ``F.rms_norm`` with the same gamma, the float32 gamma, the masked body
    forced and, on the uniform library, every thread count per row the
    vector body takes and, at (512, 4096), a cold L2."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import deepseek_moe_16b, yi_6b
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm.kernel import (launch_shape,
                                                    rmsnorm_lib_cuda)
    from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library
    from repro_torch.kernels.rmsnorm.ref import approx_rmsnorm_library_ref
    from repro_torch.models.layers import apply_norm
    from repro_torch.numerics.ops import FusedInterpNumerics

    num = FusedInterpNumerics(lib)
    rs_tol = 2 * 2.0 ** -(lib.meta("rsqrt").out_bits - 1) + 2.0 ** -7
    pow2 = torch.tensor([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], device=dev)
    out = []
    for n_rows, d in RMS_SHAPES:
        x = torch.randn(n_rows, d, device=dev, generator=g) * 2
        x[:2] = pow2[torch.randint(0, 6, (2, d), device=dev, generator=g)]
        x = x.to(torch.bfloat16)
        g32 = torch.rand(d, device=dev, generator=g) + 0.5
        g16 = g32.to(torch.bfloat16)  # the served scale, as stored
        g32 = g16.float()  # the same values as float32
        checks = {}
        for gname, gm in (("bfloat16", g16), ("float32", g32)):
            want = approx_rmsnorm_library_ref(x, gm, lib)
            for body in ("vector", "masked"):
                got = rmsnorm_lib_cuda(x, gm, lib, body=body)
                torch.cuda.synchronize()
                exact = torch.equal(got[:2], want[:2])
                gf, wf = got.float(), want.float()
                err = float((gf - wf).abs().max())
                rel = float(((gf - wf).abs() / wf.abs().clamp_min(1e-30)
                             ).max())
                checks[f"{gname} gamma, {body}"] = dict(
                    max_abs_err=err, max_rel=rel, exact_rows_bitwise=exact)
                print(f"rmsnorm_lib ({n_rows}, {d}) bf16, {gname} gamma, "
                      f"{body} body ({label} library): exact-ms rows bitwise"
                      f" {exact}, max_abs_err {err:.3e}, max rel {rel:.3e} "
                      f"(tolerance rel {rs_tol:.3e}: 2 rsqrt-table ulps + 1 "
                      f"bf16 rounding)")
                if rel > rs_tol or not exact:
                    raise AssertionError(f"rmsnorm_lib ({n_rows}, {d}) "
                                         f"{gname} {body} differs")
        fn = functools.partial(approx_rmsnorm_library, x, g16, lib)
        if not torch.equal(fn(), approx_rmsnorm_library(x, g32, lib)):
            raise AssertionError("rmsnorm_lib: bf16 gamma differs from its "
                                 "float32 cast")
        # the served call: apply_norm on the model's (B, S, D) layout
        cfg = yi_6b.CONFIG if d == yi_6b.CONFIG.d_model else \
            deepseek_moe_16b.CONFIG
        x3 = x.reshape(4, 1, d) if n_rows == 4 else x.reshape(1, n_rows, d)
        p = {"scale": g16}
        n0 = dict(build.LAUNCHES)
        served = apply_norm(p, x3, cfg, num)
        torch.cuda.synchronize()
        launched = {k: v - n0[k] for k, v in build.LAUNCHES.items()
                    if v != n0[k]}
        ops = device_ops(lambda: apply_norm(p, x3, cfg, num))
        nodes = graph_ops(lambda: apply_norm(p, x3, cfg, num))
        cast_nodes = graph_ops(lambda: num.rmsnorm(x3, g16.float()))
        same = torch.equal(served.reshape(n_rows, d), fn())
        print(f"  apply_norm {tuple(x3.shape)} bf16 scale ({label} "
              f"library): launches {launched}, device ops per call "
              f"{ops} (profiler; it may lose events), {nodes} (CUDA graph "
              f"nodes; {cast_nodes} with the scale cast first, as before), "
              f"bitwise the kernel call {same}")
        if (launched != {"rmsnorm_lib": 1} or nodes != 1 or ops > 1
                or not same):
            raise AssertionError(f"apply_norm {tuple(x3.shape)} is not one "
                                 f"rmsnorm_lib launch and one device op")
        yard = functools.partial(F.rms_norm, x, (d,), g16, 1e-6)
        b_ms, b_by = bound(2 * x.numel() * 2 + d * 2, 4 * x.numel(),
                           F32_FLOPS)
        tag = f"{label} rmsnorm ({n_rows}, {d})"
        row = dict(name="rmsnorm_lib", shape=[n_rows, d], library=label,
                   dtype="bfloat16", gamma_dtype="bfloat16",
                   launch=list(launch_shape(n_rows, d, 2, True)),
                   checks=checks, ops=ops, graph_nodes=nodes,
                   cast_graph_nodes=cast_nodes,
                   max_abs_err=checks["bfloat16 gamma, vector"]
                   ["max_abs_err"], tolerance=rs_tol,
                   ms=device_ms(fn, label=tag, kernel="rmsnorm_lib"),
                   call_ms=timed(fn),
                   plain_ms=device_ms(functools.partial(
                       approx_rmsnorm_library_ref, x, g16, lib), iters=3,
                       label=f"plain {tag}"),
                   library_ms=device_ms(yard, label=f"F.rms_norm {tag}"),
                   bound_ms=b_ms, bound_by=b_by,
                   f32_gamma_bound_ms=bound(2 * x.numel() * 2 + d * 4,
                                            4 * x.numel(), F32_FLOPS)[0],
                   **graph_cols(fn, yard))
        row["f32_gamma_graph_ms"] = graph_ms(functools.partial(
            approx_rmsnorm_library, x, g32, lib))[0]
        row["masked_graph_ms"] = graph_ms(functools.partial(
            rmsnorm_lib_cuda, x, g16, lib, body="masked"))[0]
        if label == "uniform":
            tprs = {}
            for tpr in RMS_TPRS:
                try:
                    launch_shape(n_rows, d, 2, True, tpr)
                except ValueError:
                    continue
                tprs[tpr] = graph_ms(functools.partial(
                    rmsnorm_lib_cuda, x, g16, lib, tpr=tpr))[0]
            row["tpr_graph_ms"] = tprs
        if (n_rows, d) == (512, 4096):
            row["cold_ms"] = device_ms(lambda: (flush(), fn()),
                                       label=f"cold {tag}",
                                       kernel="rmsnorm_lib", own=True)
        print(f"  rmsnorm_lib ({n_rows}, {d}) ({label}): graph "
              f"{_ms(row['graph_ms'])} (F.rms_norm {_ms(row['library_graph_ms'])}"
              f"), f32 gamma {_ms(row['f32_gamma_graph_ms'])}, masked body "
              f"{_ms(row['masked_graph_ms'])}, bound {b_ms:.5f} ms; launch "
              f"{row['launch']}; threads per row "
              f"{ {k: _ms(v) for k, v in row.get('tpr_graph_ms', {}).items()} }"
              + (f"; cold L2 {row['cold_ms']:.5f} ms" if "cold_ms" in row
                 else ""))
        out.append(row)
    return out


def l2_flush(dev):
    """A call that writes 128 MB (2.5x the H100's 50 MB L2), so that the
    next kernel finds its operands in HBM, as a serving step does."""
    import torch

    scratch = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    return scratch.zero_


def device_ops(fn, iters: int = 10) -> float:
    """Device operations (kernels, copies, fills) per ``fn()``, from the
    profiler: the fullest of three traces of ``iters`` calls (the profiler
    loses events from some traces)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(int(e.count) for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA))
    return most / iters


def graph_ops(fn) -> int | None:
    """Device operations (kernel, copy and fill nodes) one ``fn()``
    enqueues, counted in a CUDA graph that captures it (its DOT dump):
    exact where the profiler loses events. None where ``fn()`` cannot be
    captured or the dump names no node."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the dump
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the dump announces itself
        path = pathlib.Path(d) / "graph.dot"
        graph.debug_dump(str(path))
        dot = path.read_text()
    nodes = len(re.findall(r'^"graph_\d+_node_\d+"\s*\[', dot, re.M))
    return nodes or None


def act_phase(libs, dev):
    """The served activation, ``FusedInterpNumerics.silu`` (one act_lib
    launch), at every shape the served models hand it and in their layout
    (the gate half of a SwiGLU product, a ``torch.chunk`` view), on each
    ``(label, library)`` of ``libs``: bitwise against the eager chain (the
    float glue around the int32 kernel, as ``InterpNumerics`` runs it) and
    against the plain version; timed beside the chain and ``F.silu`` on the
    same view, warm (the graph replays, the profiler, and each of act_lib's
    two bodies forced) and, at Yi-6B's prefill, with a cold L2. The chain
    is the path of ``library_eval`` (uniform library) and ``library_walk``
    (segmented): their launches are counted over one chain call per shape
    and library. First, whether ATen's CUDA divide by a host scalar is a
    true divide (the glue divides by a device scalar)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.interp.kernel import act_library_cuda, slot_args
    from repro_torch.numerics.ops import (FusedInterpNumerics,
                                          InterpNumerics, PlainFusedNumerics)

    g = torch.Generator(device=dev).manual_seed(2468)
    x = torch.rand(1 << 20, device=dev, generator=g) * 12
    true_div = x / torch.full((), 12.0, device=dev)
    host_scalar_div = torch.equal(x / 12.0, true_div)
    cpu_div = torch.equal(true_div.cpu(), x.cpu() / 12.0)
    print(f"ATen on the card: x / 12.0 (a host scalar) equals the true "
          f"divide x / tensor(12.0) {host_scalar_div}; the true divide "
          f"equals the CPU's {cpu_div} (2^20 elements)")
    if not cpu_div:
        raise AssertionError("the card's tensor divide is not the CPU's")
    gates = {}
    for shape in act_shapes():
        h = (torch.randn(*shape[:-1], 2 * shape[-1], device=dev,
                         generator=g) * 3).to(torch.bfloat16)
        gates[shape] = torch.chunk(h, 2, dim=-1)[0]
    torch.cuda.synchronize()
    build.reset_launches()
    chains = {(label, shape): InterpNumerics(lib).silu(gate)
              for label, lib in libs for shape, gate in gates.items()}
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("library_eval", "library_walk")}
    print(f"the eager chain over {len(chains)} (shape, library) gates: "
          f"launches {launches}")
    flush = l2_flush(dev)
    rows, details = {}, []
    for label, lib in libs:
        fused, chain = FusedInterpNumerics(lib), InterpNumerics(lib)
        plain = PlainFusedNumerics(lib)
        sa = slot_args(lib, "silu")
        slot_bytes = 4 * (3 * sa[1] + 5 * sa[10] * bool(sa[9]))
        for shape, gate in gates.items():
            n0 = dict(build.LAUNCHES)
            got = fused.silu(gate)
            torch.cuda.synchronize()
            launched = {k: v - n0[k] for k, v in build.LAUNCHES.items()
                        if v != n0[k]}
            same_chain = torch.equal(got, chains[label, shape])
            same_plain = torch.equal(got, plain.silu(gate))
            ops = device_ops(lambda: fused.silu(gate))
            print(f"act_lib silu {shape} bf16 gate view ({label} library): "
                  f"launches {launched}, {ops} device ops per call; bitwise "
                  f"equal to the eager chain {same_chain} and to the plain "
                  f"version {same_plain} (tolerance 0)")
            if launched != {"act_lib": 1} or ops > 1 or not (
                    same_chain and same_plain):
                raise AssertionError(f"act_lib {shape} ({label}) differs")
            n = gate.numel()
            # x read once, y written once, the slot staged; ~26 float and
            # integer operations per element (glue ~14, table read ~12)
            b_ms, b_by = bound(2 * 2 * n + slot_bytes, 26 * n, F32_FLOPS)
            chain_graph, chain_why = graph_ms(lambda: chain.silu(gate))
            row = dict(name="act_lib", shape=list(shape), library=label,
                       dtype="bfloat16", layout="gate view", ops=ops,
                       max_abs_err=0.0, tolerance=0,
                       ms=device_ms(lambda: fused.silu(gate),
                                    label=f"act {label} {shape}",
                                    kernel="act_lib"),
                       call_ms=timed(lambda: fused.silu(gate)),
                       plain_ms=device_ms(lambda: plain.silu(gate), iters=3,
                                          label=f"plain act {label} {shape}"),
                       chain_ms=device_ms(lambda: chain.silu(gate),
                                          label=f"chain {label} {shape}"),
                       chain_graph_ms=chain_graph,
                       library_ms=device_ms(lambda: F.silu(gate),
                                            label=f"silu {shape}"),
                       bound_ms=b_ms, bound_by=b_by,
                       **graph_cols(lambda: fused.silu(gate),
                                    lambda: F.silu(gate)))
            if chain_why:
                row["chain_graph_ms_null"] = chain_why
            row["body_graph_ms"] = {
                body: graph_ms(lambda: act_library_cuda(gate, lib, "silu",
                                                        body=body))[0]
                for body in ("datapath", "table")}
            if shape == act_shapes()[0]:
                row["chain_ops"] = device_ops(lambda: chain.silu(gate))
                print(f"  device ops per activation: act_lib {ops}, the "
                      f"eager chain {row['chain_ops']}")
            if shape == (1, 512, 11008):
                # the layout's share: the same on a contiguous copy
                dense = gate.contiguous()
                row["contiguous_graph_ms"] = graph_ms(
                    lambda: fused.silu(dense))[0]
                row["library_contiguous_graph_ms"] = graph_ms(
                    lambda: F.silu(dense))[0]
                row["cold_ms"] = device_ms(
                    lambda: (flush(), fused.silu(gate)),
                    label=f"cold act {label}", kernel="act_lib", own=True)
                row["library_cold_ms"] = device_ms(
                    lambda: (flush(), F.silu(gate)),
                    label=f"cold silu {label}", symbol="silu", own=True)
            details.append(row)
            rows.setdefault("act_lib", row)
    for r in details:
        bodies = r["body_graph_ms"]
        print(f"  device time act_lib {r['shape']} ({r['library']}): graph "
              f"{_ms(r['graph_ms'])}, profiler {r['ms']:.5f} ms (bodies "
              f"forced: datapath {_ms(bodies['datapath'])}, table "
              f"{_ms(bodies['table'])}); F.silu graph "
              f"{_ms(r['library_graph_ms'])}, profiler "
              f"{r['library_ms']:.5f} ms; eager chain graph "
              f"{_ms(r['chain_graph_ms'])}, profiler {r['chain_ms']:.5f} ms;"
              f" plain {r['plain_ms']:.5f} ms; bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})"
              + (f"; cold L2 {r['cold_ms']:.5f} ms (F.silu + flush "
                 f"{r['library_cold_ms']:.5f} ms); on a contiguous copy graph "
                 f"{_ms(r['contiguous_graph_ms'])} (F.silu "
                 f"{_ms(r['library_contiguous_graph_ms'])})"
                 if "cold_ms" in r else ""))
    return rows, details, launches


NEW_ACTS = ("gelu", "sigmoid", "softplus", "tanh")


def new_act_phase(libs, dev) -> list[dict]:
    """The backends' gelu, sigmoid, softplus and tanh on the card
    (``FusedInterpNumerics``: one ``act_lib`` launch on the kind's slot) at
    the served decode and prefill shapes, (4, 1, 11008) and
    (1, 512, 11008) bf16, on each ``(label, library)``: bitwise against
    the plain version (tolerance 0), timed beside the PyTorch function of
    the exact backend on the same tensor."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.numerics.ops import (ExactNumerics, FusedInterpNumerics,
                                          PlainFusedNumerics)

    g = torch.Generator(device=dev).manual_seed(1357)
    xs = {shape: (torch.randn(shape, device=dev, generator=g) * 4
                  ).to(torch.bfloat16)
          for shape in ((4, 1, 11008), (1, 512, 11008))}
    rows = []
    for label, lib in libs:
        fused, plain = FusedInterpNumerics(lib), PlainFusedNumerics(lib)
        for kind in NEW_ACTS:
            for shape, x in xs.items():
                n0 = build.LAUNCHES["act_lib"]
                got = getattr(fused, kind)(x)
                torch.cuda.synchronize()
                n = build.LAUNCHES["act_lib"] - n0
                same = torch.equal(got, getattr(plain, kind)(x))
                yard = getattr(ExactNumerics, kind)
                row = dict(kind=kind, shape=list(shape), library=label,
                           launches=n, bitwise_plain=bool(same),
                           graph_ms=graph_ms(lambda: getattr(fused, kind)(x)
                                             )[0],
                           library_graph_ms=graph_ms(lambda: yard(x))[0])
                print(f"act_lib {kind} {shape} bf16 ({label} library): "
                      f"{n} launch, bitwise the plain version {same} "
                      f"(tolerance 0); graph {_ms(row['graph_ms'])}, the "
                      f"exact backend's {kind} "
                      f"{_ms(row['library_graph_ms'])}")
                if n != 1 or not same:
                    raise AssertionError(f"act_lib {kind} {shape} ({label})")
                rows.append(row)
    return rows


TAB_KERNELS = ("softmax_tab", "rmsnorm_tab", "flash_attn_tab")
# the per-table phase's shapes: Yi-6B's width (d_model, query heads, KV
# heads, head dim), its hidden rows at decode (4 slots) and in a prefill,
# softmax rows and dtype (DeepSeekMoE's router, the scores of a 512-token
# prefill over 32 heads, a D that is no multiple of 128 for the tails) and
# attention (B, Sq, Sk, causal)
PERTABLE = dict(width=(4096, 32, 4, 128), rms_rows=(4, 512),
                softmax=(((4, 64), "float32"), ((32 * 512, 512), "float32"),
                         ((37, 1000), "bfloat16")),
                attention=((4, 1, 1024, False), (1, 512, 512, True)))


def pertable_phase(lib, dev):
    """The per-table path at full Yi-6B width (d = 4096, 32 query heads over
    4 KV heads, D = 128, bf16): three design sets through
    ``approx_rmsnorm_fused``, ``approx_softmax_fused`` and
    ``attention_fused``. Launch counts are read right after that run; then
    each kernel is held against its plain version (exp codes bitwise, rsqrt
    codes bitwise on rows whose mean(x^2) is exact in any order, outputs at
    the card tests' tolerances) and, with the default R6 designs, bitwise
    against its library twin on ``lib``; then timed (every set's kernel
    time; plain versions and yardsticks on R6). Returns the kernels-line rows
    (R6), the details and the launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.api import Explorer, ExploreConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.flashattn.kernel import kv_splits, query_tile
    from repro_torch.kernels.flashattn.ops import (attention_fused,
                                                   attention_fused_library)
    from repro_torch.kernels.flashattn.ref import attention_fused_ref
    from repro_torch.kernels.rmsnorm.ops import (approx_rmsnorm_fused,
                                                 approx_rmsnorm_library)
    from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref
    from repro_torch.kernels.softmax.kernel import softmax_tab_cuda
    from repro_torch.kernels.softmax.ops import (_meta, approx_softmax_fused,
                                                 approx_softmax_library)
    from repro_torch.kernels.softmax.ref import fused_softmax_ref, softmax_exp
    from repro_torch.numerics.ops import softmax_ulp_bound

    # the three design sets through get_table, generated on the card's host
    # into a fresh cache directory: 10-bit, 12-bit R5 and the default 12-bit
    # R6 ones (those ``lib`` packs, checked below)
    kinds = ("exp2neg", "recip", "rsqrt")
    kw = {"10b": {"bits": 10}, "R5": {"lookup_bits": 5}, "R6": {}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        gen = Explorer(ExploreConfig(device=str(dev), cache_dir=d))
        sets = {name: {k: gen.get_table(k, **kw[name]) for k in kinds}
                for name in kw}
    gen_s = time.perf_counter() - t0
    for k, dz in sets["R6"].items():
        if not torch.equal(dz.device_coeffs(dev),
                           lib.coeffs[lib.func_id(k), :len(dz.a)]):
            raise AssertionError(f"R6 {k} is not the library's table")
    info = {}
    for name, ds in sets.items():
        for k, dz in ds.items():
            tab0 = int(dz.eval_int(np.array([0]))[0])
            info[f"{name} {k}"] = dict(in_bits=dz.in_bits,
                                       out_bits=dz.out_bits,
                                       rows=len(dz.a), tab0=tab0)
            print(f"design {name} {k}: in_bits {dz.in_bits}, out_bits "
                  f"{dz.out_bits}, rows {len(dz.a)}, tab(0) {tab0}")
    print(f"design sets generated in {gen_s:.3f} s")

    g = torch.Generator(device=dev).manual_seed(4321)
    bf = dict(device=dev, dtype=torch.bfloat16)
    d_model, h, kvh, hd = PERTABLE["width"]
    pow2 = torch.tensor([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], device=dev)
    rms_in = []
    for rows in PERTABLE["rms_rows"]:
        x = (torch.randn(rows, d_model, device=dev, generator=g)
             * (torch.rand(rows, 1, device=dev, generator=g) * 4 + 0.1))
        # rows of +-0.5, 1, 2: mean(x^2) exact in any order (same code)
        x[:2] = pow2[torch.randint(0, 6, (2, d_model), device=dev,
                                   generator=g)]
        rms_in.append((x.to(torch.bfloat16),
                       torch.rand(d_model, device=dev, generator=g) + 0.5))
    sm_in = [(torch.randn(shape, device=dev, generator=g) * 4).to(
        getattr(torch, dtype)) for shape, dtype in PERTABLE["softmax"]]
    att_in = []  # K/V expanded from kvh to h heads by the caller
    for b, sq, sk, causal in PERTABLE["attention"]:
        q = torch.randn(b, sq, h, hd, generator=g, **bf)
        k, v = (torch.randn(b, sk, kvh, hd, generator=g, **bf
                            ).repeat_interleave(h // kvh, dim=2)
                for _ in range(2))
        att_in.append((q, k, v, causal))

    # -- the main path: every count 0 just before, read just after --------
    build.reset_launches()
    outs = {}
    for name, ds in sets.items():
        ed, rd, sd = ds["exp2neg"], ds["recip"], ds["rsqrt"]
        outs[name] = (
            [approx_rmsnorm_fused(x, gm, sd) for x, gm in rms_in],
            [approx_softmax_fused(x, ed, rd) for x in sm_in],
            [attention_fused(q, k, v, causal=c, exp_design=ed,
                             recip_design=rd) for q, k, v, c in att_in])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want = {**dict.fromkeys(build.LAUNCHES, 0),
            "rmsnorm_tab": len(sets) * len(rms_in),
            "softmax_tab": len(sets) * len(sm_in),
            "flash_attn_tab": len(sets) * len(att_in)}
    print(f"per-table path launches: "
          f"{ {k: launches[k] for k in TAB_KERNELS} }")
    if launches != want:
        raise AssertionError(f"per-table path launches {launches}, want "
                             f"{want}")

    # -- checks against the plain versions and the library twins ----------
    details = []
    for name, ds in sets.items():
        ed, rd, sd = ds["exp2neg"], ds["recip"], ds["rsqrt"]
        ec, rc, sc = (dz.device_coeffs(dev) for dz in (ed, rd, sd))
        rms_out, sm_out, att_out = outs[name]
        rs_tol = 2 * 2.0 ** -(sd.out_bits - 1) + 2.0 ** -7
        for (x, gm), got in zip(rms_in, rms_out):
            want_r = fused_rmsnorm_ref(x, gm, sc, _meta(sd))
            codes_same = torch.equal(got[:2], want_r[:2])
            gf, wf = got.float(), want_r.float()
            err = float((gf - wf).abs().max())
            rel = float(((gf - wf).abs() / wf.abs().clamp_min(1e-30)).max())
            print(f"rmsnorm_tab {name} {tuple(x.shape)} bf16: exact-ms rows "
                  f"bitwise {codes_same}, max_abs_err {err:.3e}, max rel "
                  f"{rel:.3e} (tolerance rel {rs_tol:.3e}: 2 rsqrt-table "
                  f"ulps + 1 bf16 rounding)")
            if not codes_same or rel > rs_tol:
                raise AssertionError(f"rmsnorm_tab {name} {tuple(x.shape)} "
                                     f"differs from plain")
            details.append(dict(name="rmsnorm_tab", designs=name,
                                shape=list(x.shape), max_abs_err=err,
                                tolerance=rs_tol, x=x, gamma=gm))
        for x, got in zip(sm_in, sm_out):
            again, e = softmax_tab_cuda(x, ed, rd, return_e=True)
            _, e_ref = softmax_exp(x, ec, _meta(ed))
            want_s = fused_softmax_ref(x, ec, rc, _meta(ed), _meta(rd))
            e_exact = torch.equal(e, e_ref) and torch.equal(again, got)
            gf, wf = got.float(), want_s.float()
            err = float((gf - wf).abs().max())
            rel = float(((gf - wf).abs() / wf.abs().clamp_min(1e-30)).max())
            tol = 2.0 ** -(rd.in_bits - 1) + (
                2.0 ** -7 if x.dtype == torch.bfloat16 else 0.0)
            print(f"softmax_tab {name} {tuple(x.shape)} {str(x.dtype)[6:]}: "
                  f"exp codes bitwise {e_exact}, max_abs_err {err:.3e}, max "
                  f"rel {rel:.3e} (tolerance rel {tol:.3e}: one recip-table "
                  f"step 2^-{rd.in_bits - 1}"
                  f"{' + 1 bf16 rounding' if x.dtype == torch.bfloat16 else ''})")
            if not e_exact or rel > tol:
                raise AssertionError(f"softmax_tab {name} {tuple(x.shape)} "
                                     f"differs from plain")
            details.append(dict(name="softmax_tab", designs=name,
                                shape=list(x.shape), dtype=str(x.dtype)[6:],
                                max_abs_err=err, tolerance=tol, x=x))
        sm_bound = softmax_ulp_bound(ed, rd)
        for (q, k, v, causal), got in zip(att_in, att_out):
            gf = got.float()
            vmax = float(v.float().abs().max())
            tq = query_tile(q.shape[1], 1, q.shape[-1])
            splits = kv_splits(q.shape[0], q.shape[2], -(-q.shape[1] // tq),
                               k.shape[1])
            twin = attention_fused_ref(q, k, v, ed, rd, causal=causal,
                                       block_k=64, block_q=tq,
                                       kv_splits=splits).float()
            terr = (gf - twin).abs()
            t_excess = float((terr - sm_bound * vmax
                              - 2.0 ** -8 * twin.abs()).max())
            oracle = attention_fused_ref(q, k, v, ed, rd,
                                         causal=causal).float()
            n_tiles = (k.shape[1] + 63) // 64
            tol_abs = (n_tiles + 2) * sm_bound * vmax
            err = float((gf - oracle).abs().max())
            excess = float(((gf - oracle).abs() - tol_abs
                            - 2.0 ** -7 * (vmax + oracle.abs())).max())
            mode = "prefill" if causal else "decode"
            print(f"flash_attn_tab {name} {mode} q{tuple(q.shape)} "
                  f"Sk={k.shape[1]}: against the tile-by-tile twin "
                  f"({tq}-query tiles, {splits} key splits) max_abs_err "
                  f"{float(terr.max()):.3e}, "
                  f"mean {float(terr.mean()):.3e} (tolerance "
                  f"{sm_bound * vmax:.3e}, one table-code flip, + 2^-8 |out|)"
                  f"; against the unchunked oracle {err:.3e} (tolerance "
                  f"{tol_abs:.3e} = ({n_tiles} tiles + 2) x softmax_ulp_bound"
                  f" x max|v|, + 2^-7 (max|v| + |out|))")
            if t_excess > 0 or excess > 0:
                raise AssertionError(f"flash_attn_tab {name} {mode} differs "
                                     f"from plain")
            details.append(dict(name="flash_attn_tab", designs=name,
                                mode=mode, shape=list(q.shape) + [k.shape[1]],
                                max_abs_err=float(terr.max()),
                                tolerance=sm_bound * vmax, oracle_err=err,
                                oracle_tolerance=tol_abs, qkv=(q, k, v, causal)))
        if name == "R6":  # the reference's invariant: per-table == library
            same = {
                "rmsnorm_tab": all(torch.equal(o, approx_rmsnorm_library(
                    x, gm, lib)) for (x, gm), o in zip(rms_in, rms_out)),
                "softmax_tab": all(torch.equal(o, approx_softmax_library(
                    x, lib)) for x, o in zip(sm_in, sm_out)),
                "flash_attn_tab": all(torch.equal(o, attention_fused_library(
                    q, k, v, lib, causal=c)) for (q, k, v, c), o in
                    zip(att_in, att_out))}
            print(f"R6 per-table kernels bitwise equal to their library twins"
                  f" (library {lib.rom_sha()}): {same}")
            if not all(same.values()):
                raise AssertionError(f"a per-table kernel differs from its "
                                     f"library twin on R6: {same}")
    torch.cuda.synchronize()

    # -- times --------------------------------------------------------------
    rows = {}
    for r in details:
        name, dset = r["name"], r["designs"]
        ds = sets[dset]
        ed, rd, sd = ds["exp2neg"], ds["recip"], ds["rsqrt"]
        label = f"{dset} {name} {r['shape']}"
        if name == "rmsnorm_tab":
            x, gm = r.pop("x"), r.pop("gamma")
            fn = functools.partial(approx_rmsnorm_fused, x, gm, sd)
            coeffs = sd.device_coeffs(dev)
            plain = functools.partial(fused_rmsnorm_ref, x, gm, coeffs,
                                      _meta(sd))
            g16 = gm.to(torch.bfloat16)
            yard = functools.partial(F.rms_norm, x, (x.shape[1],), g16, 1e-6)
            nbytes = 2 * x.numel() * 2 + x.shape[1] * 4 + len(sd.a) * 12
            b_ms, b_by = bound(nbytes, 4 * x.numel(), F32_FLOPS)
        elif name == "softmax_tab":
            x = r.pop("x")
            fn = functools.partial(approx_softmax_fused, x, ed, rd)
            plain = functools.partial(
                fused_softmax_ref, x, ed.device_coeffs(dev),
                rd.device_coeffs(dev), _meta(ed), _meta(rd))
            yard = functools.partial(torch.softmax, x, -1)
            n = x.numel()
            b_ms, b_by = bound(2 * n * x.element_size()
                               + 12 * (len(ed.a) + len(rd.a)), 24 * n,
                               F32_FLOPS)
        else:
            q, k, v, causal = r.pop("qkv")
            fn = functools.partial(attention_fused, q, k, v, causal=causal,
                                   exp_design=ed, recip_design=rd)
            plain = functools.partial(attention_fused_ref, q, k, v, ed, rd,
                                      causal=causal)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            yard = functools.partial(F.scaled_dot_product_attention, qt, kt,
                                     vt, is_causal=causal)
            b, sq, h, d = q.shape
            sk = k.shape[1]
            # live (query, key) pairs per head: the causal half, or all
            pairs = b * (sq * (sq + 1) // 2 if causal else sq * sk)
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            b_ms, b_by = bound(nbytes, 4 * d * h * pairs, BF16_FLOPS)
        r.update(ms=device_ms(fn, label=label, kernel=name),
                 call_ms=timed(fn), bound_ms=b_ms, bound_by=b_by,
                 **graph_cols(fn, yard if dset == "R6" else None))
        if name == "rmsnorm_tab":  # the scale as a bf16 model stores it
            r["bf16_gamma_graph_ms"] = graph_ms(functools.partial(
                approx_rmsnorm_fused, x, g16, sd))[0]
        if dset == "R6":
            r.update(plain_ms=device_ms(plain, iters=3,
                                        label=f"plain {label}"),
                     library_ms=device_ms(yard, label=f"yardstick {label}"))
            rows.setdefault(name, r)
        print(f"  device time {name} {r['shape']} ({dset} designs): kernel "
              f"{r['ms']:.5f} ms (graph {_ms(r['graph_ms'])}), bound "
              f"{b_ms:.5f} ms ({b_by})"
              + (f", plain {r['plain_ms']:.5f} ms, library "
                 f"{r['library_ms']:.5f} ms (graph "
                 f"{_ms(r['library_graph_ms'])})" if dset == "R6" else "")
              + f"; back-to-back call {r['call_ms']:.5f} ms")
    return rows, dict(designs=info, generate_s=gen_s, checks=details,
                      launches={k: launches[k] for k in TAB_KERNELS})


def per_forward(cfg) -> dict:
    """Kernel launches of one forward pass of ``cfg`` on the main path: an
    rmsnorm before attention and before the FFN of every layer plus the
    final one; one attention per layer; one silu per dense MLP and per
    expert group of an MoE layer (routed, shared); one router softmax per
    MoE layer. An activation is one ``act_lib`` launch on either library
    (a segmented slot adds no launch)."""
    from repro_torch.models import transformer as tf

    n_moe = sum(slot[-1].ffn == "moe" for slot in tf.layer_slots(cfg))
    shared = int(bool(cfg.moe and cfg.moe.n_shared))
    from repro_torch.kernels import build

    return {**dict.fromkeys(build.LAUNCHES, 0),
            "act_lib": cfg.n_layers + n_moe * shared,
            "rmsnorm_lib": 2 * cfg.n_layers + 1,
            "flash_attn_lib": cfg.n_layers, "softmax_lib": n_moe}


def serve_phase(libs, dev, config, extra=None) -> list[dict]:
    """``config`` at full width through the engine, once per ``(label,
    library)`` of ``libs`` on the same weights; returns one result per
    library for the report. ``extra(params, cfg)`` runs on the same weights
    after the serve runs (its result under ``"extra"`` of the first). The
    parameters are freed when this returns."""
    import torch

    from repro_torch.models import transformer as tf

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 float32 matmuls would move the routing")
    cfg = config.replace(numerics="interp-fused")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"{cfg.name} params: {n_params / 1e9:.3f} B ({n_bytes / 1e9:.2f} "
          f"GB, {cfg.param_dtype}), random init "
          f"{time.perf_counter() - t0:.1f} s; peak memory during init "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    out = []
    for label, lib in libs:
        res = serve_one(params, cfg, lib, label, dev)
        res.update(n_params=n_params, n_bytes=n_bytes)
        out.append(res)
        gc.collect()  # this engine's cache goes before the next one's
        torch.cuda.empty_cache()
    if len(out) > 1:  # the same launches per forward on every library
        uni = out[0]["per_forward"]
        for res in out[1:]:
            if res["per_forward"] != uni:
                raise AssertionError(f"{res['library']} library: launches "
                                     f"per forward {res['per_forward']} "
                                     f"differ from the uniform run's {uni}")
            print(f"{cfg.name} on the {res['library']} library: "
                  f"{res['per_forward']} per forward, as the uniform run")
    if extra is not None:
        out[0]["extra"] = extra(params, cfg)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _serve_requests(eng, prompts, max_new=MAX_NEW, rid0=0):
    from repro_torch.serve.engine import Request

    for i, p in enumerate(prompts):
        eng.submit(Request(rid0 + i, p, max_new=max_new))


def _run_timed(eng) -> tuple[dict, float, dict]:
    """``eng.run()`` between synchronizes with the launch counters at 0
    just before: (streams, wall seconds, the counters just after)."""
    import torch

    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {r.rid: list(r.out) for r in done}, wall, dict(build.LAUNCHES)


TICK_PROMPTS = (300, 400, 500, 600)


def tick_profile(eng, cfg, n: int = 3, n_prof: int = 2) -> dict:
    """The engine's tick at ``SLOTS`` live slots (prompts of
    ``TICK_PROMPTS`` tokens): wall ms per decode step over ``n`` ticks of
    ``HORIZON`` steps on the host clock (each tick ends in its download),
    then device ms per step and the busy share from torch.profiler over
    ``n_prof`` more ticks (after one warm tick); ``busy_share`` is the
    profiler's device time over the unprofiled wall time."""
    import torch

    rng = np.random.default_rng(1)
    _serve_requests(eng, [rng.integers(0, cfg.vocab_size, k).astype(np.int32)
                          for k in TICK_PROMPTS],
                    max_new=1 + HORIZON * (n + n_prof + 4), rid0=1000)
    eng.step(HORIZON)  # admits all four, one tick
    if sum(r is not None for r in eng.req) != SLOTS:
        raise AssertionError("the tick profile needs every slot live")
    eng.step(HORIZON)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step(HORIZON)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (n * HORIZON)
    prof = profile_steps(lambda: eng.step(HORIZON), n=n_prof)
    dev_ms = prof.get("device_ms")
    dev_ms = None if dev_ms is None else dev_ms / HORIZON
    return dict(wall_ms_per_step=wall_ms, device_ms_per_step=dev_ms,
                busy_share=None if dev_ms is None else dev_ms / wall_ms,
                tokens_per_s=SLOTS * 1e3 / wall_ms,
                profiled_busy_share=prof.get("device_busy_share"),
                device_ops_per_tick=prof.get("device_ops"),
                profile=prof)


def serve_one(params, cfg, lib, label, dev) -> dict:
    """6 requests through the engine on ``lib``, on a graph engine (the
    main path: one CUDA graph replay per tick) and on an eager one
    (``graph=False``): completion, launch counts (the graph engine's
    ``stats["launches"]``, which adds each graph's launches on every
    replay; the eager engine's global counters too), token streams and
    final caches bitwise equal between the two, tokens/s, the tick's wall
    ms per step and busy share for both, the decode step's time and
    profile, and first tokens against a plain-version prefill on the same
    library."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import PlainFusedNumerics
    from repro_torch.serve.engine import ServeEngine, chunk_sizes

    print(f"-- {cfg.name} on the {label} library {lib.rom_sha()} "
          f"{tuple(lib.coeffs.shape)}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_LENGTHS]
    per = per_forward(cfg)
    engines, streams, walls = {}, {}, {}
    for mode in ("graph", "eager"):
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params, slots=SLOTS, cache_len=CACHE_LEN,
                          library=lib, horizon=HORIZON,
                          graph=mode == "graph", device=dev)
        build_s = time.perf_counter() - t0
        if eng.stats["graph"] != (mode == "graph"):
            raise AssertionError(f"{mode} engine: stats {eng.stats}")
        _serve_requests(eng, prompts)
        streams[mode], walls[mode], launches = _run_timed(eng)
        engines[mode] = eng
        if sorted(streams[mode]) != list(range(len(prompts))):
            raise AssertionError(f"{mode}: not every request completed")
        for rid, out in streams[mode].items():
            if len(out) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in out):
                raise AssertionError(f"{mode} request {rid}: bad stream "
                                     f"{out}")
        forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
        expected = {k: n * forwards for k, n in per.items()}
        # a replay runs no Python wrapper: the global counters see the
        # graph engine's prefills only
        wrappers = (expected if mode == "eager" else
                    {k: n * eng.stats["prefills"] for k, n in per.items()})
        print(f"{cfg.name} {mode} engine (built in {build_s:.2f} s, "
              f"{eng.stats['captures']} graphs captured in "
              f"{eng.stats['capture_s']:.2f} s): {eng.stats['prefills']} "
              f"prefills + {eng.stats['decode_steps']} decode steps = "
              f"{forwards} forwards x {per} per forward; stats launches "
              f"{eng.stats['launches']}, wrapper counters {launches}, "
              f"expected {expected}; {eng.stats['ticks']} ticks, "
              f"{eng.stats['dispatches']} dispatches, "
              f"{eng.stats['transfers']} transfers")
        if eng.stats["launches"] != expected or launches != wrappers:
            raise AssertionError(f"{mode}: kernel launch counts differ "
                                 f"from the path")
        if mode == "graph":  # the main path's counts, before the profile
            main = dict(launches=dict(eng.stats["launches"]),
                        wrapper_launches=launches, forwards=forwards,
                        stats=json.loads(json.dumps(eng.stats)))
            if eng.stats["captures"] != len(chunk_sizes(HORIZON)):
                raise AssertionError("one graph per chunk size expected")
    if streams["graph"] != streams["eager"]:
        raise AssertionError(f"graph and eager streams differ: {streams}")
    same_cache = [bool(torch.equal(a, b)) for a, b in
                  zip(engines["graph"].caches, engines["eager"].caches)]
    print(f"graph vs eager: token streams equal (6 x {MAX_NEW}); caches "
          f"k, v, pos equal {same_cache}")
    if not all(same_cache):
        raise AssertionError("graph and eager caches differ")
    n_tok = sum(len(v) for v in streams["graph"].values())
    ticks = {}
    for mode, eng in engines.items():
        # an eager tick's trace holds ~27k device ops a tick: one is read
        ticks[mode] = phase(f"tick profile ({mode})", tick_profile, eng, cfg,
                            n_prof=2 if mode == "graph" else 1)
        t = ticks[mode]
        print(f"{mode} tick at {SLOTS} live slots: {n_tok / walls[mode]:.2f} "
              f"tokens/s end to end (prefills included); tick wall "
              f"{t['wall_ms_per_step']:.3f} ms per step "
              f"({t['tokens_per_s']:.1f} tokens/s), device "
              f"{_ms(t['device_ms_per_step'])} per step, busy share "
              f"{_share(t['busy_share'])} (profiled "
              f"{_share(t['profiled_busy_share'])})")
    eng = engines["graph"]
    del engines["eager"]
    gc.collect()
    torch.cuda.empty_cache()

    # decode step time at 4 live slots on the filled cache
    num = eng.numerics
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    tok = torch.zeros((SLOTS, 1), dtype=torch.int64, device=dev)
    pos = torch.tensor([300, 400, 500, 600], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        step_ms = timed(lambda: tf.decode_step(params, tok, pos, eng.caches,
                                               cfg, num), iters=10)
    weight_ms = n_bytes / HBM_BPS * 1e3
    print(f"decode step (4 slots, positions 300-600, cache {CACHE_LEN}): "
          f"{step_ms:.3f} ms; weight-streaming bound {weight_ms:.3f} ms "
          f"({n_bytes / 1e9:.2f} GB / {HBM_BPS / 1e12:.2f} TB/s)")
    with torch.inference_mode():
        prof = profile_steps(lambda: tf.decode_step(params, tok, pos,
                                                    eng.caches, cfg, num))
        longest = int(np.argmax(SERVE_LENGTHS))
        long_prompt = torch.as_tensor(prompts[longest], dtype=torch.int64,
                                      device=dev)[None]
        print(f"prefill of the {SERVE_LENGTHS[longest]}-token prompt:")
        prof_pre = profile_steps(lambda: tf.prefill(params, long_prompt, cfg,
                                                    num, CACHE_LEN), n=1)

    # first tokens against a plain-version prefill on the card
    plain = PlainFusedNumerics(lib)
    max_dlogit = 0.0
    ties = 0
    with torch.inference_mode():
        for rid, p in enumerate(prompts):
            first = streams["graph"][rid][0]
            t = torch.as_tensor(p, dtype=torch.int64, device=dev)[None]
            lp, _ = tf.prefill(params, t, cfg, plain, CACHE_LEN)
            lk, _ = tf.prefill(params, t, cfg, num, CACHE_LEN)
            lp, lk = lp[0, -1].float(), lk[0, -1].float()
            if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
                raise AssertionError(f"request {rid}: non-finite logits")
            if int(lk.argmax()) != first:
                raise AssertionError(f"request {rid}: engine first token "
                                     f"{first} != its own prefill")
            d = float((lk - lp).abs().max())
            max_dlogit = max(max_dlogit, d)
            tol = 2.0 ** -5 * float(lp.abs().max())
            gap = float(lp.max() - lp[first])
            if gap > 0:
                ties += 1
                if gap > tol:
                    raise AssertionError(
                        f"request {rid}: first token {first} trails the "
                        f"plain prefill's argmax by {gap} > {tol}")
    print(f"first tokens vs plain prefill: {len(prompts) - ties} equal, "
          f"{ties} inside the tie band (2^-5 max|logit|); max |dlogit| "
          f"{max_dlogit:.4f}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{cfg.name} peak device memory {peak / 1e9:.2f} GB")
    return dict(model=cfg.name, library=label, rom_sha=lib.rom_sha(),
                wall_s=walls["graph"], tokens=n_tok,
                tokens_per_s=n_tok / walls["graph"],
                eager_wall_s=walls["eager"],
                eager_tokens_per_s=n_tok / walls["eager"], ticks=ticks,
                decode_step_ms=step_ms, weight_bound_ms=weight_ms,
                decode_profile=prof, prefill_profile=prof_pre,
                per_forward=per, **main, peak_bytes=peak,
                max_dlogit=max_dlogit,
                first_token_ties=ties, caches_equal=same_cache,
                streams=streams["graph"])


def yi_extra_phases(params, cfg, lib, dev) -> dict:
    """On the loaded Yi-6B weights: the serial oracle, then the card fault
    phase."""
    return {"serial_oracle": phase("serial oracle", serial_oracle_phase,
                                   params, cfg, dev),
            "faults": phase("faults", fault_phase, params, cfg, lib, dev)}


def serial_oracle_phase(params, cfg, dev) -> dict:
    """The serial path (one decode forward and a host argmax per token)
    against the graph tick, both with exact numerics, on the 6 serve
    requests: bitwise equal streams."""
    import torch

    from repro_torch.serve.engine import ServeEngine

    cfg = cfg.replace(numerics="exact")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_LENGTHS]
    out, walls, stats = {}, {}, {}
    for fused in (True, False):
        eng = ServeEngine(cfg, params, slots=SLOTS, cache_len=CACHE_LEN,
                          horizon=HORIZON, fused=fused, device=dev)
        if eng.stats["graph"] != fused:
            raise AssertionError(f"fused={fused}: graph {eng.stats}")
        _serve_requests(eng, prompts)
        out[fused], walls[fused], _ = _run_timed(eng)
        stats[fused] = {k: eng.stats[k] for k in
                        ("dispatches", "transfers", "ticks", "decode_steps")}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print(f"serial oracle, exact numerics, {cfg.name}: serial "
          f"{walls[False]:.2f} s {stats[False]}, graph tick "
          f"{walls[True]:.2f} s {stats[True]}; streams equal "
          f"{out[True] == out[False]}")
    if out[True] != out[False]:
        raise AssertionError(f"serial and graph streams differ: {out}")
    return dict(streams_equal=True, serial_s=walls[False],
                graph_s=walls[True], serial_stats=stats[False],
                graph_stats=stats[True])


def fault_phase(params, cfg, lib, dev) -> dict:
    """The ladder on the card, 3 requests x 8 tokens on the loaded weights:
    a ROM flip at construction serves exact tokens identical to an exact
    engine's; NaN ticks retire the slots and, past the watchdog limit,
    move the engine to the serial rung with guarded numerics (the library
    kernels) that finishes the rest; a journaled run killed at a crash
    point resumes to the streams of an uninterrupted run."""
    import torch

    from repro_torch.faults import (Crashed, TickFaultInjector,
                                    arm_crashpoint, flip_rom_bit,
                                    reset_crashpoints)
    from repro_torch.kernels import build
    from repro_torch.numerics.guard import GuardedNumerics
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.journal import load_requests

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 90, 250)]
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, horizon=HORIZON, device=dev)
    res = {}

    def serve(eng, max_new=8):
        _serve_requests(eng, prompts, max_new)
        out = {r.rid: list(r.out) for r in eng.run()}
        return out

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # a ROM bit flip at construction: straight to exact, exact's tokens
    eng = ServeEngine(cfg, params, library=flip_rom_bit(lib, seed=5), **kw)
    if not (eng.stats["rom_faults"] == 1 and eng.cfg.numerics == "exact"
            and eng.library is None and eng.stats["graph"]):
        raise AssertionError(f"ROM flip: {eng.faults} {eng.stats}")
    got = serve(eng)
    faults_flip = list(eng.faults)
    del eng
    free()
    want = serve(ServeEngine(cfg.replace(numerics="exact"), params, **kw))
    free()
    print(f"ROM flip at construction: {faults_flip[0]['action']} "
          f"({faults_flip[0]['reason']}); tokens equal to an exact "
          f"engine's {got == want}")
    if got != want:
        raise AssertionError("the ROM-flip engine's tokens differ from "
                             "exact numerics")
    res["rom_flip"] = dict(faults=faults_flip, tokens_equal=True)

    # NaN ticks: retire, then the serial rung with guarded numerics
    eng = ServeEngine(cfg, params, library=lib, watchdog_limit=2,
                      **{**kw, "slots": 1})
    TickFaultInjector("nan", every_n=1, limit=2).install(eng)
    before = dict(build.LAUNCHES)
    serve(eng)
    torch.cuda.synchronize()
    errors = [(r.rid, r.error) for r in eng.failed]
    finished = {r.rid: len(r.out) for r in eng.finished}
    walk = sum(build.LAUNCHES[k] - before[k]
               for k in ("library_eval", "library_walk"))
    print(f"NaN ticks: failed {errors}, finished {finished}, rung "
          f"{eng._rung()}, numerics {type(eng.numerics).__name__} "
          f"({eng.cfg.numerics}); faults {eng.faults}; library_eval / "
          f"library_walk launches on the serial rung {walk}")
    if not (errors == [(0, "non_finite_output"), (1, "non_finite_output")]
            and finished == {2: 8} and not eng.fused
            and eng.cfg.numerics == "interp-guarded"
            and isinstance(eng.numerics, GuardedNumerics) and walk > 0):
        raise AssertionError("the NaN ladder did not reach the serial rung")
    res["nan"] = dict(failed=errors, finished=finished, faults=eng.faults,
                      serial_table_launches=walk)
    del eng
    free()

    # crash and resume, journaled, on the graph engine
    want = serve(ServeEngine(cfg, params, library=lib,
                             **{**kw, "horizon": 2}))
    free()
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        jp = pathlib.Path(d) / "serve.jsonl"
        eng = ServeEngine(cfg, params, library=lib, journal=str(jp),
                          **{**kw, "horizon": 2})
        arm_crashpoint("serve.tick.emitted", after=1)
        try:
            serve(eng)
            raise AssertionError("the crash point never fired")
        except Crashed:
            pass
        finally:
            reset_crashpoints()
        eng.close()
        del eng
        free()
        pre = {rid: len(st.out) for rid, st in load_requests(jp).items()}
        resumed = ServeEngine.resume(str(jp), cfg, params, library=lib,
                                     **{**kw, "horizon": 2})
        resumed.run()
        resumed.close()
        final = {rid: st.out for rid, st in load_requests(jp).items()}
    print(f"crash at serve.tick.emitted: durable tokens {pre}; resumed "
          f"{resumed.stats['resumed']} ({resumed.stats['resume_replay_steps']}"
          f" teacher-forced steps); streams equal to the uninterrupted run "
          f"{final == want}")
    if final != want or not resumed.stats["resumed"]:
        raise AssertionError(f"resume: {final} != {want}")
    res["resume"] = dict(durable=pre, resumed=resumed.stats["resumed"],
                         replay_steps=resumed.stats["resume_replay_steps"],
                         streams_equal=True)
    del resumed
    free()
    return res


def profile_steps(step, n: int = 3) -> dict:
    """Device time of ``n`` calls of ``step`` from torch.profiler (CUPTI):
    busy share of the wall time, the port's kernels' device time per
    launch, and the top device ops. Profiling adds host overhead, so the
    busy share is a lower bound for the unprofiled run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():  # device-side kernels and copies only
        if e.device_type == DeviceType.CUDA and _dev_us(e) > 0:
            rows.append((e.key, _dev_us(e), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    device_ops = sum(r[2] for r in rows) / n  # kernels, copies and fills
    kernels = {}
    for name in SERVE_KERNELS:
        hit = [r for r in rows if KERNEL_SYMBOLS[name] in r[0]]
        n_launch = sum(r[2] for r in hit)
        kernels[name] = (sum(r[1] for r in hit) / n_launch / 1e3
                         if n_launch else None)
    if not rows:
        print("profiler: no device time recorded (not measured)")
        return {"device_busy_share": None}
    print(f"profiler, {n} calls: device busy {busy / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall = {busy / wall_us:.3f} busy share; "
          f"{device_ops:.1f} device ops (kernels, copies, fills) per call")
    for name, ms in kernels.items():
        print(f"  {name}: device {ms:.5f} ms per launch" if ms is not None
              else f"  {name}: no launches in the trace")
    for key, dev_us, count in rows[:10]:
        print(f"  top device op: {dev_us / n / 1e3:.4f} ms/step "
              f"x{count // n} {key[:90]}")
    return {"device_busy_share": busy / wall_us, "wall_ms": wall_us / 1e3 / n,
            "device_ms": busy / 1e3 / n, "device_ops": device_ops,
            "kernel_device_ms": kernels,
            "top": [(k[:120], d / 1e3 / n, c // n) for k, d, c in rows[:15]]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.numerics.ops import _quantize

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must not run in TF32")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{build.BUILD_LOG['path']}")
    OUT.mkdir(exist_ok=True)
    (OUT / "build_log.txt").write_text(build.BUILD_LOG["output"])
    for line in build.BUILD_LOG["output"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    dspace_rows, dspace_details = phase("dspace kernels", dspace_kernel_phase,
                                        dev)
    gen = phase("generator", generator_phase, dev)
    lib = gen.pop("library")  # compiled on the card in this run
    print(f"library {lib.rom_sha()} {tuple(lib.coeffs.shape)} (compiled on "
          f"the card)")
    designs = gen.pop("designs")
    seg_gen, seg_lib, seg_designs = phase("segmented generator",
                                          segmented_generator_phase, dev)
    gen["segmented"] = seg_gen
    m = lib.meta("silu")

    def silu_codes(gate):
        xc = torch.clamp(gate.float(), m.act_lo, m.act_hi - 1e-6)
        return _quantize((xc - m.act_lo) / (m.act_hi - m.act_lo), m.in_bits)

    ie_row, ie_details = phase("interp_eval", interp_eval_phase, designs,
                               dev, silu_codes)

    walk_rows, walk_details = phase("walk", walk_phase, seg_lib, seg_designs,
                                    lib, designs, dev, silu_codes)
    rows, details = phase("kernels", kernel_phases, lib, dev, silu_codes)
    _, seg_details = phase("kernels", kernel_phases, seg_lib, dev,
                           silu_codes, "segmented")
    act_rows, act_details, act_launches = phase(
        "act_lib", act_phase, [("uniform", lib), ("segmented", seg_lib)], dev)
    new_acts = phase("new activations", new_act_phase,
                     [("uniform", lib), ("segmented", seg_lib)], dev)
    tab_rows, pertable = phase("per-table", pertable_phase, lib, dev)
    from repro_torch.configs import deepseek_moe_16b, yi_6b

    serves = phase("serve yi_6b", serve_phase, [("uniform", lib)], dev,
                   yi_6b.CONFIG, extra=lambda params, cfg: yi_extra_phases(
                       params, cfg, lib, dev))
    gc.collect()  # the Yi-6B weights and cache go before DeepSeekMoE's init
    torch.cuda.empty_cache()
    print(f"after freeing yi_6b: {torch.cuda.memory_allocated(dev) / 1e9:.2f} "
          f"GB allocated, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    serves += phase("serve deepseek_moe_16b", serve_phase,
                    [("uniform", lib), ("segmented", seg_lib)], dev,
                    deepseek_moe_16b.CONFIG)
    launches = {name: sum(sv["launches"][name] for sv in serves)
                for name in build.LAUNCHES}
    launches.update(gen["launches"])
    launches["rom_eval"] = seg_gen["launches"]["rom_eval"]
    for name in ENVELOPE_KERNELS:
        launches[name] += seg_gen["launches"][name]
    launches.update(pertable["launches"])
    # the int32 table reads run on the eager chain (act_phase), not in
    # serving, whose activations are act_lib launches
    launches.update(act_launches)
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on the paths: "
                             f"{launches}")

    kernels = []
    replaces = {
        "library_eval": ("src/repro_torch/csrc/interp.cu",
                         "src/repro/kernels/interp/kernel.py:241"),
        # library_eval_2d (or library_walk_2d) with the activation's float
        # glue around it (repro/numerics/ops.py _range_glue, _act_tails)
        "act_lib": ("src/repro_torch/csrc/interp.cu",
                    "src/repro/kernels/interp/kernel.py:241"),
        "rmsnorm_lib": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm/kernel.py:62"),
        "flash_attn_lib": ("src/repro_torch/csrc/flashattn.cu",
                           "src/repro/kernels/flashattn/kernel.py:220"),
        "softmax_lib": ("src/repro_torch/csrc/softmax.cu",
                        "src/repro/kernels/softmax/kernel.py:90"),
        "interp_eval": ("src/repro_torch/csrc/interp.cu",
                        "src/repro/kernels/interp/kernel.py:366"),
        "library_walk": ("src/repro_torch/csrc/interp.cu",
                         "src/repro/kernels/interp/kernel.py:336"),
        "rom_eval": ("src/repro_torch/csrc/interp.cu",
                     "src/repro/kernels/interp/kernel.py:175"),
        "softmax_tab": ("src/repro_torch/csrc/softmax.cu",
                        "src/repro/kernels/softmax/kernel.py:113"),
        "rmsnorm_tab": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm/kernel.py:86"),
        "flash_attn_tab": ("src/repro_torch/csrc/flashattn.cu",
                           "src/repro/kernels/flashattn/kernel.py:188"),
        "envelopes_parity": ("src/repro_torch/csrc/dspace.cu",
                             "src/repro/kernels/dspace/kernel.py:99"),
        "envelopes_parity_batched": ("src/repro_torch/csrc/dspace.cu",
                                     "src/repro/kernels/dspace/kernel.py:150"),
        "envelopes_parity_fleet": ("src/repro_torch/csrc/dspace.cu",
                                   "src/repro/kernels/dspace/kernel.py:123"),
        # glue, no TPU kernel: the jnp reduction inside the same program
        "dd_max_rows": ("src/repro_torch/csrc/dspace.cu",
                        "src/repro/kernels/dspace/ops.py:79"),
    }
    rows = {**rows, **dspace_rows, **walk_rows, **tab_rows, **act_rows,
            "interp_eval": ie_row}
    for name, (source, rep) in replaces.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": rep,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "graph_ms": r["graph_ms"],
                        "library_graph_ms": r["library_graph_ms"]})
    report = {"device": smi[0], "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build.BUILD_LOG["seconds"],
              "kernel_phases": (dspace_details + ie_details + walk_details
                                + details + seg_details + act_details),
              "new_activations": new_acts,
              "generator": gen, "pertable": pertable, "serve": serves,
              "event_timed": EVENT_TIMED, "short_traces": SHORT_TRACES,
              "phase_s": PHASE_S}
    if EVENT_TIMED:
        print(f"timed with CUDA events (no profiler device time): "
              f"{EVENT_TIMED}")
    if SHORT_TRACES:
        print(f"kernel times per launch from traces that lost launches: "
              f"{SHORT_TRACES}")
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
