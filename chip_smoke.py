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
   then runs the persistent DSE on the card (``dse_phase``, studies in a
   temporary directory): the committed ``artifacts/dse/study9`` replayed
   from a copy (0 executed, 120 replayed, its frontier FRONTIER_10.json's
   bytes outside ``meta``, the committed files unchanged), the full
   default space fresh under the modeled serve probe (600 trials, 48
   infeasible, frontier groups 3 / 4 / 5, the reference frontier's
   sha256 outside ``meta``, the first 120 records the journal's, a resume
   executing 0), the same 120 trials under ``engine="pallas"`` (the
   envelope and ``dd_max_rows`` kernels per (spec, R)) equal to the
   journal, the smoke preset under the wall probe (each serving shape's
   wall tokens/s; the smoke Yi-6B's engines read the library through
   ``library_eval``) and ``launch.dse plan --arch yi_6b --smoke``; its
   launches stand under ``launches_by_path["dse"]``;
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
   busy share from torch.profiler); then, on the same weights, the
   roofline phase (``roofline_phase``: the graph tick's decode step
   profiled on fake tensors on the host by the dry run's profiler,
   ``launch.xprof``, its bytes at least the weights and cache it reads,
   its launches the tick's, the measured device ms at least 0.95 x its
   bound, its argument bytes what the engine holds; temp bytes beside
   ``max_memory_allocated``; one production cell traced), the serial
   oracle (exact numerics, one decode and a host argmax per token) against
   the graph tick, bitwise, and the fault phase: a ROM bit flip at
   construction serving exact numerics' tokens, NaN ticks retiring slots
   and moving the engine to the serial rung with guarded numerics, and a
   journaled run killed at a crash point resuming to the uninterrupted
   streams; then the plan phase: a uniform interp-fused plan against the
   homogeneous graph engine (streams and final caches bitwise), a
   three-slot plan (layer 0 on an R5 library generated on the card, layer
   1 on the segmented one, the rest on the default; launches per forward
   per slot library, first tokens against the plain versions) and an R5
   ROM flip mid-run that takes layer 0 alone to exact, recaptures and
   finishes; then the AOT phase: the 6 requests and a second group of 4
   same-bucket prompts through the graph-only engine and through
   ``aot_buckets=True, max_pack=4`` (one CUDA graph per (bucket, pack)),
   capture seconds, memory, tokens/s end to end, zero misses, each packed
   group's first tokens against the plain ``prefill_padded``, streams
   against the graph-only engine's in the tie band, a packed admission
   replayed and eager (wall, device ms, busy share); and the host
   pipeline (``async_host=True``: streams bitwise the synchronous AOT
   run's, a journaled async run stopped mid-run and resumed); then the
   mesh phase (``mesh_phase``): a world-1 NCCL process group, the 6
   requests through an unmeshed AOT graph engine and through
   ``ServeEngine(mesh=make_serve_mesh(1, 1), aot_buckets=True)`` (streams,
   caches and kernel launches bitwise; the tick graphs holding their
   all-reduces and all-gathers; the requests again with deadlines on a
   fault clock that expires one live and one queued request and a
   journal, outcomes, streams and journal bytes equal between the two;
   both ticks' wall ms per step and tokens/s, without and with
   deadlines), one train step of the first 8 layers on a ``1 x 1`` mesh
   against the unmeshed step (the loss bitwise), and the fleet's probe
   split on the card against one program;
9. frees Yi-6B and serves (graph and eager) full-width DeepSeekMoE-16B
   cut to 14 of its 28 layers (64 routed experts top-6 + 2 shared, a
   dense layer 0; the
   router's softmax through the ``softmax_lib`` kernel), first on the
   uniform library, then on the same weights on the segmented library,
   where the activations and every table read of the fused kernels go
   through the segment decode: the same launches per forward; then its
   AOT phase on the uniform library (first tokens held against the plain
   ``prefill_padded``: an MoE bucket's expert capacity is the bucket's);
10. serves the other decoder families at full width on the uniform
   library (random bf16 weights from a seed), freeing each model before
   the next: MiniCPM3-4B (62 layers of MLA: Dk 96 / Dv 64 attention over
   the latent expansion) on a graph and an eager engine with the tick
   profile, then its AOT phase; Mixtral-8x22B cut to 8 layers (full
   width, 8 experts top-2, the 4096-token window: a slot cache of 4096
   rows) on prompts of 4104, 4090, 200 and 17 tokens, graph ≡ eager on the
   wrapped ring, the tick on 4 wrapped rings, and the first decode tokens
   past the wrap against a plain-version re-prefill of the grown
   sequence (the prompts past 4096 keys prefill through the glue path,
   whose table reads are ``library_eval`` launches); Qwen1.5-110B cut to 4
   layers (QKV bias) and Minitron-8B (squared ReLU) on a graph engine;
   Mamba2-130M whole (24 SSD layers) on a graph and an eager engine with
   the serial oracle, and Jamba-v0.1 cut to 8 of its 32 layers (one
   period: 7 Mamba layers, 1 attention layer, 4 MoE and 4 dense MLP
   layers) on a graph and an eager engine, both on prompts of 17 / 64 /
   200 / 512 / 33 / 128 tokens (a prompt past the 256-token SSD chunk
   must be whole chunks) and the tick on 256 / 512-token prompts, graph ≡
   eager with the conv windows and recurrent states; InternVL2-2B whole
   (24 layers, 16 heads over 8) on a graph and an eager engine, served as
   a text decoder as the reference serves it, then through its model
   entry with 256 float32 patch embeddings from a seed projected into the
   first rows of a 300-token prompt and 16 greedy decodes, every token
   held against the plain versions; Whisper-tiny whole (4 + 4 layers,
   LayerNorm, learned positions) through its model entry, which the
   engine refuses: the encoder over (4, 1500, 384) float32 frames, a
   4-token prefill with the encoder output as ``cross`` into a 448-row
   cache and 64 greedy decode steps, the encoder output and every token
   held against the plain versions, the decode step timed against its
   bound; before that, the
   serving kernels at the shapes these models hand them
   (``family_kernel_phase``: flash at MLA's Dk 96 / Dv 64 with a strided
   V, on a wrapped window ring, at 64 heads over 8 and at Jamba's 32 over
   8; RMSNorm at 768, 256, 2560, 6144 and 8192; the router softmax over 8
   and 16 experts; ``ssm_kernel_rows``: the gated norm's float32 gamma,
   the mixer's silu and float32 softplus, the exp_neg table reads of a
   decode step and of a 512-token prefill; ``encdec_kernel_rows``: flash
   without the causal mask over Whisper's 1500 frames, in its cross
   attention (every position 0) and at InternVL's decode, gelu at
   Whisper's and InternVL's widths);
11. trains (``train_phase``): full-width Yi-6B cut to 8 of its 32 layers
   (bf16, ``remat="block"``, 4 x 2048 tokens a step in 2 microbatches)
   through ``make_train_step``, 6 steps under exact numerics (ms per step
   on CUDA events, tokens/s, peak memory, the model-FLOPs share, the busy
   share of one more step) and 3 from the same initial state under interp
   numerics bound to the uniform library (the unfused glue: every table
   read a ``library_eval`` launch, counted from 0 over the run), the
   step-0 loss within the reference's bound of the exact one and bitwise
   the plain evaluator's (``library_eval_ref``) on the same card; then
   Mamba2-130M whole through the ``Trainer`` (8 x 512 tokens, a
   checkpoint every 2 steps), a run cut after step 3 and resumed from
   its checkpoint within rtol 1e-5 of the straight run;
12. prints the throughput, a ``{"kernels": [...]}`` JSON line (each
   serving kernel's row with its ``family_shapes``; ``library_eval``'s
   launches include the interp train run's) and, last,
   ``{"ok": true, "device": {...}}``.

Any failure raises (non-zero exit) before the last line. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
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
# kernels the main path does not launch, and why; each must launch on its
# own path (``launches_by_path``)
OFF_MAIN_PATH = {"library_walk": "the served activations are act_lib "
                 "launches; the int32 walk runs on the eager chain (the "
                 "interp backend's activation on the segmented library)"}
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


# the committed DSE artifacts the DSE phase holds the port to
STUDY9 = ROOT / "artifacts" / "dse" / "study9"
FRONTIER_10 = ROOT / "artifacts" / "dse" / "FRONTIER_10.json"
# sha256 of the reference's full default-space frontier without ``meta``,
# as ``save_frontier`` serializes it (600 trials, 48 infeasible)
DEFAULT_FRONTIER_SHA = ("85cb0a67f7567a1f758c9c52c3dfbbb8"
                        "8e85612b3a2c568666ea9085cc5f5f04")
DEFAULT_FRONTIER_GROUPS = {"asic": 3, "fpga-lut": 4, "pallas-tpu": 5}
# a trial's table metrics (the probe adds the throughput ones)
TABLE_M = ("area", "delay", "accuracy_margin", "degree", "k")


def _frontier_bytes(doc: dict) -> str:
    """A frontier document as ``save_frontier`` writes it, ``meta`` removed
    (the port stamps ``"torch"`` and its device there)."""
    return json.dumps({k: v for k, v in doc.items() if k != "meta"},
                      indent=1, sort_keys=True)


def _held_records(records: dict, want: list[dict], label: str,
                  engine: str) -> None:
    """Each record in ``records`` (in order) against the journal record
    ``want`` of the same position: params (``engine`` aside), status,
    metrics and objectives equal."""
    got = [r.to_dict() for r in records.values()][:len(want)]
    bad = [(w["key"], g["status"], g["metrics"], w["metrics"])
           for g, w in zip(got, want)
           if g["params"] != {**w["params"], "engine": engine}
           or any(g[f] != w[f] for f in ("status", "metrics", "objectives"))]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{label}: {len(bad)} of {len(want)} records "
                             f"differ from the committed journal: {bad[:3]}")


def dse_phase(dev) -> dict:
    """The persistent DSE on the card through its entry points: every
    Explorer (``engine="batched"`` and ``"pallas"``), the serve probe's
    smoke Yi-6B engines and the plan CLI on ``dev``. Studies live in a
    temporary directory (the committed study9 is replayed from a copy, its
    files held unchanged), and the default Explorer is a fresh one on the
    card over a temporary table cache. Launch counts are set to 0 at the
    start and read at the end: the envelope kernels' from the counters,
    the probe engines' from their ``stats["launches"]`` (graph replays
    included) in place of their host-side counts."""
    import hashlib
    import shutil

    import torch

    from repro_torch.api import (Explorer, ExploreConfig, default_explorer,
                                 set_default_explorer)
    from repro_torch.dse import Study, compare_frontiers, load_frontier
    from repro_torch.dse.space import PRESETS, default_space
    from repro_torch.kernels import build
    from repro_torch.launch import dse as dse_cli

    out: dict = {}
    journal = [json.loads(line) for line in
               (STUDY9 / "journal.jsonl").read_text().splitlines()]
    digests = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
               for p in STUDY9.iterdir() if p.is_file()}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="dse_"))
    old = default_explorer()
    set_default_explorer(Explorer(ExploreConfig(
        device=str(dev), cache_dir=str(tmp / "tables"))))
    probe_eager = dict.fromkeys(build.LAUNCHES, 0)
    probe_served = dict.fromkeys(build.LAUNCHES, 0)
    graph_reasons = set()

    def study(root, space=None, **kw):
        """A Study on the card whose probe's host-side launch counts are
        kept apart (its engines' own counts replace them)."""
        st = Study(tmp / root, space, device=dev, **kw)
        real = st.probe._serve_once

        def serve_once(p):
            before = dict(build.LAUNCHES)
            try:
                dt, stats, tokens = real(p)
            finally:
                for k, n in build.LAUNCHES.items():
                    probe_eager[k] += n - before[k]
            for k, n in stats.get("launches", {}).items():
                probe_served[k] += n
            graph_reasons.add(stats.get("graph_reason"))
            return dt, stats, tokens

        st.probe._serve_once = serve_once
        return st

    def timed_run(st, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = st.run(**kw)
        torch.cuda.synchronize()
        return recs, time.perf_counter() - t0

    build.reset_launches()
    try:
        # 1. the committed study9, replayed from a copy
        shutil.copytree(STUDY9, tmp / "study9")
        with study("study9") as st:
            recs, _ = timed_run(st, max_trials=0)
            replay = dict(st.stats)
            fresh = load_frontier(st.write_frontier(recs))
        if replay != {"executed": 0, "replayed": 120, "infeasible": 0}:
            raise AssertionError(f"study9 replay: {replay}")
        committed = load_frontier(FRONTIER_10)
        if _frontier_bytes(fresh) != _frontier_bytes(committed) or \
                compare_frontiers(fresh, committed):
            raise AssertionError("study9 replay: frontier != FRONTIER_10")
        out["study9_replay"] = {**replay, "frontier_equal": True}

        # 2. the full default space, fresh, under the modeled probe
        with study("default", default_space(), measure="modeled") as st:
            recs, wall = timed_run(st)
            row = st.summary()
            front = st.frontier(recs)
        sha = hashlib.sha256(_frontier_bytes(front).encode()).hexdigest()
        groups = {t: len(p) for t, p in front["groups"].items()}
        _held_records(recs, journal, "default space (batched)", "batched")
        table = {}  # (kind, R, target) -> the table metrics, from this run
        for r in recs.values():
            if r.ok:
                table[(r.params.kind, r.params.lookup_bits,
                       r.params.target)] = {k: r.metrics[k] for k in TABLE_M}
        if (front["trials"] != {"completed": 552, "infeasible": 48}
                or groups != DEFAULT_FRONTIER_GROUPS
                or sha != DEFAULT_FRONTIER_SHA):
            raise AssertionError(f"default space: {front['trials']}, "
                                 f"{groups}, sha256 {sha}")
        with study("default") as st:
            _, t_resume = timed_run(st)
            resumed = dict(st.stats)
        if resumed["executed"] or resumed["replayed"] != 600:
            raise AssertionError(f"default space resume: {resumed}")
        eval_s = [r.timing.get("eval_s", 0.0) for r in recs.values()]
        out["default_space"] = {
            "trials": len(recs), "wall_s": wall,
            "trials_per_s": len(recs) / wall,
            "mean_eval_s": float(np.mean(eval_s)),
            "probe_runs": row["probe_runs"],
            "probe_cache_hits": row["probe_cache_hits"],
            "frontier": front["trials"], "groups": groups,
            "frontier_sha256": sha, "first_120_equal_journal": True,
            "resume": resumed, "resume_s": t_resume}
        print(f"  default space: {len(recs)} trials in {wall:.1f} s "
              f"({len(recs) / wall:.2f} trials/s), frontier {groups}, "
              f"sha {sha[:12]}; resume executed 0 in {t_resume:.2f} s")

        # 3. the study9 prefix under engine="pallas": the envelope and
        # dd_max_rows kernels per (spec, R) on the card
        env0 = {k: build.LAUNCHES[k] for k in ENVELOPE_KERNELS}
        space = dataclasses.replace(default_space(), engines=("pallas",))
        with study("pallas", space, measure="modeled") as st:
            recs, wall = timed_run(st, max_trials=120)
        _held_records(recs, journal, "study9 prefix (pallas)", "pallas")
        out["pallas_prefix"] = {
            "trials": len(recs), "wall_s": wall, "equal_journal": True,
            "launches": {k: build.LAUNCHES[k] - env0[k]
                         for k in ENVELOPE_KERNELS}}
        print(f"  study9 prefix under pallas: {len(recs)} trials in "
              f"{wall:.1f} s, {out['pallas_prefix']['launches']}")

        # 4. the smoke preset under the wall probe: the served kernels at
        # each shape, the library compiled at each trial's R
        with study("wall", PRESETS["smoke"](), measure="wall") as st:
            recs, wall = timed_run(st)
        bad = {key: r.metrics for key, r in
               (((r.params.kind, r.params.lookup_bits, r.params.target), r)
                for r in recs.values())
               if {k: r.metrics[k] for k in TABLE_M} != table[key]}
        if bad or len(recs) != 16:
            raise AssertionError(f"smoke preset (wall): {len(recs)} trials; "
                                 f"table metrics unlike the default "
                                 f"space's: {bad}")
        shapes = {}
        for r in recs.values():
            p = r.params
            shapes[f"fused={p.fused} R={p.lookup_bits} batch={p.batch} "
                   f"horizon={p.horizon}"] = r.timing["wall_tokens_per_s"]
        out["smoke_wall"] = {"trials": len(recs), "wall_s": wall,
                             "wall_tokens_per_s": shapes}
        print(f"  smoke preset under wall: {len(recs)} trials in "
              f"{wall:.1f} s; wall tokens/s {shapes}")

        # 5. the plan CLI on the card
        t0 = time.perf_counter()
        rc = dse_cli.main(["plan", "--arch", "yi_6b", "--smoke", "--budget",
                           "0.05", "--device", str(dev), "--save-plan",
                           str(tmp / "plan.json")])
        if rc:
            raise AssertionError(f"launch.dse plan exited {rc}")
        out["plan"] = {"rc": rc, "wall_s": time.perf_counter() - t0}
        torch.cuda.synchronize()
    finally:
        set_default_explorer(old)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: n - probe_eager[k] + probe_served[k]
                for k, n in build.LAUNCHES.items()}
    if not (launches["library_eval"] and launches["envelopes_parity_batched"]
            and launches["dd_max_rows"]):
        raise AssertionError(f"dse: kernels not launched: {launches}")
    if digests != {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                   for p in STUDY9.iterdir() if p.is_file()}:
        raise AssertionError("the committed study9 changed")
    out["launches"] = launches
    out["probe_graph_reasons"] = sorted(map(str, graph_reasons))
    gc.collect()
    torch.cuda.empty_cache()
    return out


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

    from repro_torch.kernels.interp.ops import library_eval
    from repro_torch.kernels.interp.ref import library_eval_ref

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
        row = flash_lib_row(lib, q, k, v, q_pos, kv_pos, mode=mode,
                            label=label)
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


def flash_lib_row(lib, q, k, v, q_pos, kv_pos, *, mode: str, label: str,
                  window: int | None = None, tag: str = "",
                  causal: bool = True) -> dict:
    """``flash_attn_lib`` on (q, k, v) (the model's layouts: K/V views of
    the cache or strided slices; ``causal=False`` for Whisper's encoder and
    cross attention) against its plain version ((n_tiles + 2)
    x softmax_ulp_bound x max|v|, + 2^-7 (max|v| + |out|) in bf16) and its
    tile-by-tile twin with the kernel's query tile and key splits (one
    table-code flip + 2^-8 |out|), timed beside SDPA on the same inputs
    and mask. The bound counts the (query, key) pairs this data needs
    (causal, the window, dead rows) and each live K/V row read once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flashattn.kernel import kv_splits, query_tile
    from repro_torch.kernels.flashattn.ops import attention_fused_library
    from repro_torch.kernels.flashattn.ref import attention_fused_library_ref
    from repro_torch.numerics.ops import softmax_ulp_bound

    sm_bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    dtype = q.dtype
    q_pos, kv_pos = q_pos.to(torch.int32), kv_pos.to(torch.int32)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, window=window, causal=causal)
    got = attention_fused_library(q, k, v, lib, **kw).float()
    want = attention_fused_library_ref(q, k, v, lib, **kw).float()
    torch.cuda.synchronize()
    vmax = float(v.float().abs().max())
    n_tiles = (sk + 63) // 64
    tol_abs = (n_tiles + 2) * sm_bound * vmax
    excess = float(((got - want).abs() - tol_abs
                    - 2.0 ** -7 * (vmax + want.abs())).max())
    err = float((got - want).abs().max())
    name = f"{mode}{' ' + tag if tag else ''}"
    print(f"flash_attn_lib {name} {str(dtype)[6:]} B={b} H={h} KVH={kvh} "
          f"D={d} Dv={dv} Sq={sq} Sk={sk} window={window}: max_abs_err "
          f"{err:.3e} (tolerance {tol_abs:.3e} = ({n_tiles} tiles + 2) x "
          f"softmax_ulp_bound {sm_bound:.3e} x max|v|, + 2^-7 (max|v| + "
          f"|out|) bf16 roundings)")
    if excess > 0:
        raise AssertionError(f"flash_attn_lib {name} differs from plain")
    tq = query_tile(sq, h // kvh, dv)
    splits = kv_splits(b, kvh, -(-sq // tq), sk)
    twin = attention_fused_library_ref(q, k, v, lib, block_k=64, block_q=tq,
                                       kv_splits=splits, **kw).float()
    terr = (got - twin).abs()
    t_excess = float((terr - sm_bound * vmax - 2.0 ** -8 * twin.abs()).max())
    print(f"  against the tile-by-tile twin (64-key tiles, {tq}-query "
          f"tiles, {splits} key splits): max_abs_err "
          f"{float(terr.max()):.3e}, mean {float(terr.mean()):.3e} "
          f"(tolerance {sm_bound * vmax:.3e} = one table-code flip, + "
          f"2^-8 |out| one bf16 rounding)")
    if t_excess > 0:
        raise AssertionError(f"flash_attn_lib {name} differs from the "
                             f"tile-by-tile twin")
    # the work this data needs: live (query, key) pairs per head
    dpos = q_pos[:, :, None] - kv_pos[:, None, :]
    live = (kv_pos[:, None, :] >= 0) & ((dpos >= 0) | (not causal))
    if window is not None:
        live &= dpos < window
    pairs = int(live.sum())
    live_rows = int(live.any(1).sum())
    es = q.element_size()
    # q read at D, the output written at Dv, the live K / V rows read once
    nbytes = ((q.numel() + b * sq * h * dv) * es
              + live_rows * kvh * (d + dv) * es
              + kv_pos.numel() * 4 + q_pos.numel() * 4)
    b_ms, b_by = bound(nbytes, 2 * (d + dv) * h * pairs,
                       BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = live[:, None]

    every = bool(live.all())

    def sdpa():
        if not causal and every:  # every key live: no mask tensor
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True)
        if mode == "prefill" and window is None:  # no mask tensor
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qt, kt, vt, mask,
                                              enable_gqa=True)
    fn = functools.partial(attention_fused_library, q, k, v, lib, **kw)
    label_ = f"{label} flash {name} H={h}"
    return dict(name="flash_attn_lib", shape=[b, sq, h, kvh, d, sk],
                dv=dv, window=window, causal=causal, mode=name,
                dtype=str(dtype)[6:],
                max_abs_err=err, tolerance=tol_abs,
                ms=device_ms(fn, label=label_, kernel="flash_attn_lib"),
                call_ms=timed(fn),
                plain_ms=device_ms(functools.partial(
                    attention_fused_library_ref, q, k, v, lib, **kw),
                    iters=3, label=f"plain {label_}"),
                library_ms=device_ms(sdpa, label=f"sdpa {label_}"),
                bound_ms=b_ms, bound_by=b_by, kv_splits=splits,
                **graph_cols(fn, sdpa))


# softmax_lib's shapes: DeepSeekMoE's router at decode (4 slots) and in
# the 511-token prefill (64 experts, float32), a wide bf16 row, and the
# per-table phase's two large calls (the same body): ragged bf16 rows and a
# 512-token prefill's scores over 32 heads
SOFTMAX_SHAPES = (((4, 64), "float32"), ((511, 64), "float32"),
                  ((8, 4096), "bfloat16"), ((37, 1000), "bfloat16"),
                  ((16384, 512), "float32"))
SOFTMAX_TPRS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def softmax_lib_rows(lib, dev, g, flush, label, shapes=SOFTMAX_SHAPES):
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
    for shape, dname in shapes:
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


def rmsnorm_lib_rows(lib, dev, g, flush, label, shapes=RMS_SHAPES):
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

    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm.kernel import (launch_shape,
                                                    rmsnorm_lib_cuda)
    from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library
    from repro_torch.kernels.rmsnorm.ref import approx_rmsnorm_library_ref
    from repro_torch.configs.yi_6b import CONFIG as rms_cfg
    from repro_torch.models.layers import apply_norm
    from repro_torch.numerics.ops import FusedInterpNumerics

    num = FusedInterpNumerics(lib)
    rs_tol = 2 * 2.0 ** -(lib.meta("rsqrt").out_bits - 1) + 2.0 ** -7
    pow2 = torch.tensor([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], device=dev)
    out = []
    for n_rows, d in shapes:
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
        x3 = x.reshape(4, 1, d) if n_rows == 4 else x.reshape(1, n_rows, d)
        p = {"scale": g16}
        n0 = dict(build.LAUNCHES)
        served = apply_norm(p, x3, rms_cfg, num)
        torch.cuda.synchronize()
        launched = {k: v - n0[k] for k, v in build.LAUNCHES.items()
                    if v != n0[k]}
        ops = device_ops(lambda: apply_norm(p, x3, rms_cfg, num))
        nodes = graph_ops(lambda: apply_norm(p, x3, rms_cfg, num))
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


# the new families' kernel shapes: MLA's norms (q_norm 768, kv_norm 256) and
# the residual norms of MiniCPM3 (2560), Mixtral (6144) and Qwen (8192) at
# decode; Mixtral's router (8 experts) over a tick's 4 x 16 rows
FAMILY_RMS_SHAPES = ((4, 768), (4, 256), (4, 2560), (4, 6144), (4, 8192))
# Mixtral's router (8 experts) and Jamba's (16) over a tick's 4 x 16 rows
FAMILY_SOFTMAX_SHAPES = (((4 * 16, 8), "float32"),
                         ((4 * 16, 16), "float32"))


def family_kernel_phase(lib, dev) -> list[dict]:
    """The serving kernels at the shapes the new families hand them, each
    against its plain version (the tolerances of ``kernel_phases``) and
    timed beside its yardstick: ``flash_attn_lib`` at MiniCPM3's MLA decode
    (4 slots, 1024 cache rows, 40 heads over 40, Dk 96 against Dv 64, V
    the strided second half of the latent expansion) and prefill (511
    tokens), at Mixtral's decode on a wrapped 4096-row window ring (48
    heads over 8; the slots' rings rotated by 0, 1, 4095 and 105 rows, so
    that positions are not ordered along the rows) and at Qwen's decode
    (64 heads over 8); ``rmsnorm_lib`` at ``FAMILY_RMS_SHAPES`` and
    ``softmax_lib`` at ``FAMILY_SOFTMAX_SHAPES``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2424)
    bf = dict(device=dev, dtype=torch.bfloat16)
    flush = l2_flush(dev)
    out = []
    lens = torch.tensor([17, 300, 1000, 600], device=dev)

    def cache_rows(b, sk):
        kv_pos = torch.arange(sk, device=dev).expand(b, sk).clone()
        kv_pos[kv_pos >= lens[:, None]] = -1
        return kv_pos, (lens - 1)[:, None]

    # MiniCPM3's MLA: K (nope + rope) and V sliced out of the expansion
    for mode, b, sq, sk in (("decode", 4, 1, 1024), ("prefill", 1, 511, 511)):
        kvb = torch.randn(b, sk, 40, 128, generator=g, **bf)
        k = torch.cat([kvb[..., :64], torch.randn(b, sk, 1, 32, generator=g,
                                                  **bf).expand(b, sk, 40,
                                                               32)], -1)
        v = kvb[..., 64:]
        if mode == "decode":
            kv_pos, q_pos = cache_rows(b, sk)
        else:
            kv_pos = q_pos = torch.arange(sk, device=dev).expand(b, sk)
        q = torch.randn(b, sq, 40, 96, generator=g, **bf)
        out.append(flash_lib_row(lib, q, k, v, q_pos, kv_pos, mode=mode,
                                 label="uniform", tag="mla"))
    # Mixtral's wrapped ring: row r holds the position p with p % 4096 == r
    b, sk = 4, 4096
    kc = torch.randn(b, 8, sk, 128, generator=g, **bf)
    vc = torch.randn(b, 8, sk, 128, generator=g, **bf)
    last = torch.tensor([8191, 8192, 12286, 4200], device=dev)
    kv_pos = last[:, None] - torch.remainder(
        last[:, None] - torch.arange(sk, device=dev), sk)
    q = torch.randn(b, 1, 48, 128, generator=g, **bf)
    out.append(flash_lib_row(lib, q, kc.transpose(1, 2), vc.transpose(1, 2),
                             last[:, None], kv_pos, mode="decode",
                             label="uniform", window=4096, tag="ring"))
    # Qwen1.5-110B: 64 query heads over 8 at decode
    kc = torch.randn(b, 8, 1024, 128, generator=g, **bf)
    vc = torch.randn(b, 8, 1024, 128, generator=g, **bf)
    kv_pos, q_pos = cache_rows(b, 1024)
    q = torch.randn(b, 1, 64, 128, generator=g, **bf)
    out.append(flash_lib_row(lib, q, kc.transpose(1, 2), vc.transpose(1, 2),
                             q_pos, kv_pos, mode="decode", label="uniform",
                             tag="h64"))
    # Jamba's attention layer: 32 query heads over 8 at decode
    kc = torch.randn(b, 8, 1024, 128, generator=g, **bf)
    vc = torch.randn(b, 8, 1024, 128, generator=g, **bf)
    q = torch.randn(b, 1, 32, 128, generator=g, **bf)
    out.append(flash_lib_row(lib, q, kc.transpose(1, 2), vc.transpose(1, 2),
                             q_pos, kv_pos, mode="decode", label="uniform",
                             tag="jamba"))
    out += rmsnorm_lib_rows(lib, dev, g, flush, "uniform",
                            shapes=FAMILY_RMS_SHAPES)
    out += softmax_lib_rows(lib, dev, g, flush, "uniform",
                            shapes=FAMILY_SOFTMAX_SHAPES)
    out += ssm_kernel_rows(lib, dev, g)
    out += encdec_kernel_rows(lib, dev, g)
    for r in out:
        r.setdefault("library", "uniform")
        print(f"  device time {r['name']} {r['shape']} {r.get('mode', '')}"
              f": graph {_ms(r['graph_ms'])}, yardstick "
              f"{_ms(r['library_graph_ms'])}, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.5f} ms, "
              f"max_abs_err {r['max_abs_err']:.3e}")
    return out


# Whisper-tiny's attention (6 heads over 6, D 64) over its 1500 source
# frames, 4 slots; the 4-token prompt of its run
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 4
# gelu where Whisper's MLP (1536 wide: a 1500-frame encoder layer, a decode
# step) and InternVL's projector (256 patches, 2048 wide, float32) take it
GELU_SHAPES = (((4, 1500, 1536), "bfloat16"), ((4, 1, 1536), "bfloat16"),
               ((1, 256, 2048), "float32"))


def encdec_kernel_rows(lib, dev, g) -> list[dict]:
    """The serving kernels where the encoder-decoder and the VLM take them:
    ``flash_attn_lib`` without the causal mask over Whisper's 1500 frames
    (the encoder: B 4, 1500 x 1500, 6 heads over 6, D 64, against SDPA with
    no mask), in cross attention (every query and key position 0: one
    query row at decode, the 4-token prompt at prefill, 1500 keys) and at
    InternVL's decode (16 heads over 8, D 128, 1024 cache rows);
    ``act_lib`` gelu at ``GELU_SHAPES``, bitwise the plain version, timed
    beside ``F.gelu(approximate="tanh")``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.numerics.ops import FusedInterpNumerics, PlainFusedNumerics

    bf = dict(device=dev, dtype=torch.bfloat16)
    b, s = SLOTS, WHISPER_FRAMES
    out = []
    k = torch.randn(b, s, 6, 64, generator=g, **bf)
    v = torch.randn(b, s, 6, 64, generator=g, **bf)
    frames = torch.arange(s, device=dev).expand(b, s)
    out.append(flash_lib_row(
        lib, torch.randn(b, s, 6, 64, generator=g, **bf), k, v, frames,
        frames, mode="prefill", label="uniform", tag="whisper encoder",
        causal=False))
    zeros = torch.zeros((b, s), dtype=torch.int32, device=dev)
    for mode, sq in (("decode", 1), ("prefill", WHISPER_PROMPT)):
        q = torch.randn(b, sq, 6, 64, generator=g, **bf)
        out.append(flash_lib_row(
            lib, q, k, v, zeros[:, :sq], zeros, mode=mode, label="uniform",
            tag="whisper cross", causal=False))
    # InternVL2-2B: 16 query heads over 8 at decode on 4 slots' cache rows
    lens = torch.tensor([17, 300, 1000, 600], device=dev)
    kv_pos = torch.arange(CACHE_LEN, device=dev).expand(b, CACHE_LEN).clone()
    kv_pos[kv_pos >= lens[:, None]] = -1
    kc = torch.randn(b, 8, CACHE_LEN, 128, generator=g, **bf)
    vc = torch.randn(b, 8, CACHE_LEN, 128, generator=g, **bf)
    out.append(flash_lib_row(
        lib, torch.randn(b, 1, 16, 128, generator=g, **bf),
        kc.transpose(1, 2), vc.transpose(1, 2), (lens - 1)[:, None], kv_pos,
        mode="decode", label="uniform", tag="internvl"))
    fused, plain = FusedInterpNumerics(lib), PlainFusedNumerics(lib)
    for shape, dt in GELU_SHAPES:
        x = (torch.randn(shape, device=dev, generator=g) * 4).to(
            getattr(torch, dt))
        got = fused.gelu(x)
        same = torch.equal(got, plain.gelu(x))
        print(f"act_lib gelu {shape} {dt}: bitwise the plain version {same} "
              f"(tolerance 0)")
        if not same:
            raise AssertionError(f"act_lib gelu {shape} differs")
        b_ms, b_by = bound(2 * x.numel() * x.element_size(), 12 * x.numel(),
                           F32_FLOPS)
        fn = functools.partial(fused.gelu, x)
        yard = functools.partial(F.gelu, x, approximate="tanh")
        label = f"act_lib gelu {shape}"
        out.append(dict(name="act_lib", shape=list(shape), mode="gelu " + dt,
                        max_abs_err=0.0, tolerance=0, bound_ms=b_ms,
                        bound_by=b_by,
                        ms=device_ms(fn, label=label, kernel="act_lib"),
                        plain_ms=device_ms(functools.partial(plain.gelu, x),
                                           iters=3, label=f"plain {label}"),
                        library_ms=device_ms(yard, label=f"F.gelu {shape}"),
                        **graph_cols(fn, yard)))
    return out


# the SSM mixer's widths: (d_inner, conv_dim, in_proj width, heads) of
# Mamba2-130M and Jamba-v0.1, and the SSD chunk (models/ssm.py)
SSM_WIDTHS = {"mamba2": (1536, 1792, 3352, 24), "jamba": (8192, 8224, 16544,
                                                         128)}
SSD_CHUNK = 256


def ssm_kernel_rows(lib, dev, g) -> list[dict]:
    """The serving kernels at the shapes the SSM mixer hands them, each
    against its plain version and timed beside its yardstick:
    ``rmsnorm_lib`` on the gated norm (4 slots, d_inner 1536 / 8192, bf16
    x, float32 gamma as the mixer passes it: 2 rsqrt-table ulps + one bf16
    rounding), ``act_lib`` (bitwise) on the conv output's silu (4 x
    conv_dim, bf16), on the gate z's silu (a strided view of the (4,
    in_proj) projection, bf16) and on dt's softplus (4 x heads, float32),
    and ``library_eval`` (bitwise) on the exp_neg codes of a decode step's
    decay (4 x heads) and of a 512-token prefill's masked intra-chunk
    decay (2 chunks x 256 x 256 x heads) beside ``torch.exp``; each
    exp_neg row also times the whole ``exp_neg`` (glue and kernel,
    ``glue_graph_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.interp.ops import library_eval
    from repro_torch.kernels.interp.ref import LOG2E, library_eval_ref
    from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library
    from repro_torch.kernels.rmsnorm.ref import approx_rmsnorm_library_ref
    from repro_torch.numerics.ops import (FusedInterpNumerics,
                                          PlainFusedNumerics, _quantize)

    fused, plain = FusedInterpNumerics(lib), PlainFusedNumerics(lib)
    rs_tol = 2 * 2.0 ** -(lib.meta("rsqrt").out_bits - 1) + 2.0 ** -7
    out = []

    def row(name, shape, tag, fn, plain_fn, yard, nbytes, flops, err, tol):
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        r = dict(name=name, shape=list(shape), mode=tag, max_abs_err=err,
                 tolerance=tol, bound_ms=b_ms, bound_by=b_by,
                 ms=device_ms(fn, label=f"{name} {tag} {shape}",
                              kernel=name),
                 plain_ms=device_ms(plain_fn, iters=3,
                                    label=f"plain {name} {tag} {shape}"),
                 library_ms=device_ms(yard, label=f"yardstick {tag} {shape}"),
                 **graph_cols(fn, yard))
        out.append(r)
        return r

    for model, (d_inner, conv_dim, width, heads) in SSM_WIDTHS.items():
        # the gated norm: bf16 x, the float32 scale
        x = (torch.randn(4, d_inner, device=dev, generator=g) * 2
             ).to(torch.bfloat16)
        g32 = torch.rand(d_inner, device=dev, generator=g) + 0.5
        got = approx_rmsnorm_library(x, g32, lib)
        want = approx_rmsnorm_library_ref(x, g32, lib)
        gf, wf = got.float(), want.float()
        rel = float(((gf - wf).abs() / wf.abs().clamp_min(1e-30)).max())
        print(f"rmsnorm_lib {model} gated norm (4, {d_inner}) bf16, f32 "
              f"gamma: max rel {rel:.3e} (tolerance {rs_tol:.3e})")
        if rel > rs_tol:
            raise AssertionError(f"rmsnorm_lib gated norm {model} differs")
        row("rmsnorm_lib", (4, d_inner), f"{model} gated, f32 gamma",
            functools.partial(approx_rmsnorm_library, x, g32, lib),
            functools.partial(approx_rmsnorm_library_ref, x, g32, lib),
            lambda x=x, g32=g32: F.rms_norm(x.float(), (d_inner,), g32,
                                            1e-6).to(torch.bfloat16),
            4 * x.numel() + 4 * d_inner, 4 * x.numel(),
            float((gf - wf).abs().max()), rs_tol)
        # the activations, at the mixer's decode layouts
        proj = (torch.randn(4, 1, width, device=dev, generator=g) * 4
                ).to(torch.bfloat16)
        conv = (torch.randn(4, conv_dim, device=dev, generator=g) * 4
                ).to(torch.bfloat16)
        dt = torch.randn(4, heads, device=dev, generator=g) * 3
        for kind, a, tag in (("silu", conv, f"{model} conv"),
                             ("silu", proj[..., :d_inner], f"{model} z view"),
                             ("softplus", dt, f"{model} dt f32")):
            got = getattr(fused, kind)(a)
            same = torch.equal(got, getattr(plain, kind)(a))
            print(f"act_lib {kind} {tag} {tuple(a.shape)} {a.dtype}: bitwise "
                  f"the plain version {same} (tolerance 0)")
            if not same:
                raise AssertionError(f"act_lib {kind} {tag} differs")
            yard = F.silu if kind == "silu" else F.softplus
            row("act_lib", tuple(a.shape), tag,
                functools.partial(getattr(fused, kind), a),
                functools.partial(getattr(plain, kind), a),
                functools.partial(yard, a), 2 * a.numel() * a.element_size(),
                12 * a.numel(), 0.0, 0)
        # the exp_neg table reads: a decode step's decay, a 512-token
        # prefill's masked intra-chunk decay (arguments <= 0)
        fid = lib.func_id("exp2neg")
        m = lib.meta("exp2neg")
        meta = lib.meta_rows()
        cum = -torch.cumsum(torch.rand(1, 2, SSD_CHUNK, heads, device=dev,
                                       generator=g) * 0.05, 2)
        for tag, arg in (
                (f"{model} decode decay", -torch.rand(
                    4, heads, device=dev, generator=g) * 3),
                (f"{model} prefill masked decay", torch.clamp(
                    cum[..., :, None, :] - cum[..., None, :, :], max=0.0))):
            t = torch.clamp(torch.clamp(-arg, min=0.0) * LOG2E, max=126.0)
            codes = _quantize(t - torch.floor(t), m.in_bits)
            got = library_eval(codes, fid, lib.coeffs, meta)
            fids = torch.full_like(codes, fid)
            want = library_eval_ref(codes, fids, lib.coeffs, meta)
            err = int((got - want).abs().max())
            print(f"library_eval {tag} {tuple(codes.shape)}: max_abs_err "
                  f"{err} (tolerance 0)")
            if err:
                raise AssertionError(f"library_eval {tag} differs")
            r = row("library_eval", tuple(codes.shape), tag,
                    functools.partial(library_eval, codes, fid, lib.coeffs,
                                      meta),
                    functools.partial(library_eval_ref, codes, fids,
                                      lib.coeffs, meta),
                    functools.partial(torch.exp, arg), 8 * codes.numel(),
                    12 * codes.numel(), float(err), 0)
            r["glue_graph_ms"] = graph_ms(functools.partial(fused.exp_neg,
                                                            arg))[0]
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


def per_forward(cfg, mode: str = "decode") -> dict:
    """Kernel launches of one forward pass of ``cfg`` on the main path (a
    "prefill" or a "decode"): an rmsnorm before the mixer of every layer,
    before the FFN of every layer that has one, the final one, MLA's
    q_norm and kv_norm and the SSM mixer's gated norm; one attention per
    attention layer; one activation per SwiGLU MLP and per expert group of
    an MoE layer (routed, shared; a squared-ReLU MLP reads no table) and
    three per SSM layer (the conv output's silu, dt's softplus, the gate's
    silu); one router softmax per MoE layer; the SSM recurrence's exp_neg
    table reads (``library_eval``: the masked intra-chunk decay,
    ``to_end``, ``chunk_decay`` and ``from_start`` in a prefill, the
    step's decay in a decode). An activation is one ``act_lib`` launch on
    either library (a segmented slot adds no launch). A prefill whose
    attention passes ``FUSED_ATTN_MAX_KEYS`` keys takes the glue path
    instead of ``flash_attn_lib`` (``glue_prefill_launches``). An
    encoder-decoder adds one cross attention per layer, and its LayerNorms
    read no table; ``mode="encoder"`` counts ``encoder_forward``: one
    attention and one gelu per encoder layer."""
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf

    if mode == "encoder":
        n = cfg.encoder.n_layers
        return {**dict.fromkeys(build.LAUNCHES, 0), "flash_attn_lib": n,
                "act_lib": n}
    kinds = [slot[-1] for slot in tf.layer_slots(cfg)]
    n_moe = sum(k.ffn == "moe" for k in kinds)
    n_mlp = 0 if cfg.act == "relu2" else sum(k.ffn == "mlp" for k in kinds)
    n_ssm = sum(k.mixer == "ssm" for k in kinds)
    n_ffn = sum(k.ffn is not None for k in kinds)
    shared = int(bool(cfg.moe and cfg.moe.n_shared))
    mla = 2 * (cfg.n_layers - n_ssm) if cfg.mla is not None else 0
    norms = (0 if cfg.norm == "layernorm"
             else cfg.n_layers + n_ffn + mla + n_ssm + 1)
    cross = cfg.n_layers if cfg.encoder is not None else 0
    return {**dict.fromkeys(build.LAUNCHES, 0),
            "act_lib": n_mlp + n_moe * (1 + shared) + 3 * n_ssm,
            "rmsnorm_lib": norms,
            "flash_attn_lib": cfg.n_layers - n_ssm + cross,
            "softmax_lib": n_moe,
            "library_eval": (4 if mode == "prefill" else 1) * n_ssm}


def serve_phase(libs, dev, config, extra=None, **serve_kw) -> list[dict]:
    """``config`` at full width through the engine, once per ``(label,
    library)`` of ``libs`` on the same weights (``serve_one`` with
    ``serve_kw``); returns one result per library for the report.
    ``extra(params, cfg, result)`` runs on the same weights after the serve
    runs (its result under ``"extra"`` of the first). The parameters are
    freed when this returns."""
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
        res = serve_one(params, cfg, lib, label, dev, **serve_kw)
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
        out[0]["extra"] = extra(params, cfg, out[0])
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


def tick_profile(eng, cfg, n: int = 3, n_prof: int = 2,
                 lengths=TICK_PROMPTS) -> dict:
    """The engine's tick at ``SLOTS`` live slots (prompts of ``lengths``
    tokens): wall ms per decode step over ``n`` ticks of
    ``HORIZON`` steps on the host clock (each tick ends in its download),
    then device ms per step and the busy share from torch.profiler over
    ``n_prof`` more ticks (after one warm tick); ``busy_share`` is the
    profiler's device time over the unprofiled wall time."""
    import torch

    rng = np.random.default_rng(1)
    _serve_requests(eng, [rng.integers(0, cfg.vocab_size, k).astype(np.int32)
                          for k in lengths],
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


def glue_prefill_launches(params, cfg, num, n: int, cache_len: int,
                          dev) -> dict:
    """Kernel launches of one prefill of an ``n``-token prompt: a prompt
    past ``FUSED_ATTN_MAX_KEYS`` keys takes ``attention_core``'s glue path
    (``exp_neg`` / ``recip_pos`` through ``library_eval``) instead of
    ``flash_attn_lib``; counted on one prefill of a random prompt (the
    glue's launches do not depend on the tokens below ``SKIP_CHUNKS`` key
    chunks)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf

    toks = torch.zeros((1, n), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    before = dict(build.LAUNCHES)
    with torch.inference_mode():
        tf.prefill(params, toks, cfg, num, cache_len)
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in build.LAUNCHES.items()}


def serve_one(params, cfg, lib, label, dev, lengths=SERVE_LENGTHS,
              cache_len=CACHE_LEN, tick_lengths=TICK_PROMPTS,
              modes=("graph", "eager")) -> dict:
    """Requests of ``lengths`` tokens through the engine on ``lib`` (slot
    cache ``cache_len``), on a graph engine (the main path: one CUDA graph
    replay per tick) and, where ``modes`` has it, on an eager one
    (``graph=False``): completion, launch counts (the graph engine's
    ``stats["launches"]``, which adds each graph's launches on every
    replay; the eager engine's global counters too), token streams and
    final caches bitwise equal between the two, tokens/s, the tick's wall
    ms per step and busy share at 4 live slots (prompts of
    ``tick_lengths``), the decode step's time and profile, and first
    tokens against a plain-version prefill on the same library."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import (FUSED_ATTN_MAX_KEYS,
                                          PlainFusedNumerics)
    from repro_torch.serve.engine import ServeEngine, chunk_sizes

    print(f"-- {cfg.name} on the {label} library {lib.rom_sha()} "
          f"{tuple(lib.coeffs.shape)}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    per = per_forward(cfg)
    per_prefill = per_forward(cfg, "prefill")
    engines, streams, walls = {}, {}, {}
    for mode in modes:
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params, slots=SLOTS, cache_len=cache_len,
                          library=lib, horizon=HORIZON,
                          graph=mode == "graph", device=dev)
        if mode == modes[0]:  # each prompt's prefill launches
            pre = {k: 0 for k in per}
            for n in lengths:
                one = (per_prefill if n <= FUSED_ATTN_MAX_KEYS else
                       glue_prefill_launches(params, cfg, eng.numerics, n,
                                             cache_len, dev))
                pre = {k: pre[k] + one[k] for k in per}
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
        expected = {k: n * eng.stats["decode_steps"] + pre[k]
                    for k, n in per.items()}
        # a replay runs no Python wrapper: the global counters see the
        # graph engine's prefills only
        wrappers = expected if mode == "eager" else pre
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
    same_cache = None
    if "eager" in streams:
        if streams["graph"] != streams["eager"]:
            raise AssertionError(f"graph and eager streams differ: "
                                 f"{streams}")
        same_cache = [bool(torch.equal(a, b)) for a, b in zip(
            tf.cache_leaves(engines["graph"].caches),
            tf.cache_leaves(engines["eager"].caches))]
        print(f"graph vs eager: token streams equal ({len(prompts)} x "
              f"{MAX_NEW}); cache leaves (k, v, pos; SSM conv, ssm) equal "
              f"{same_cache}")
        if not all(same_cache):
            raise AssertionError("graph and eager caches differ")
    n_tok = sum(len(v) for v in streams["graph"].values())
    ticks = {}
    for mode, eng in engines.items():
        # an eager tick's trace holds ~27k device ops a tick and its wall
        # is the host's: one tick is timed and one read
        graph = mode == "graph"
        ticks[mode] = phase(f"tick profile ({mode})", tick_profile, eng, cfg,
                            n=3 if graph else 1, n_prof=2 if graph else 1,
                            lengths=tick_lengths)
        t = ticks[mode]
        print(f"{mode} tick at {SLOTS} live slots: {n_tok / walls[mode]:.2f} "
              f"tokens/s end to end (prefills included); tick wall "
              f"{t['wall_ms_per_step']:.3f} ms per step "
              f"({t['tokens_per_s']:.1f} tokens/s), device "
              f"{_ms(t['device_ms_per_step'])} per step, busy share "
              f"{_share(t['busy_share'])} (profiled "
              f"{_share(t['profiled_busy_share'])})")
    eng = engines["graph"]
    engines.pop("eager", None)
    gc.collect()
    torch.cuda.empty_cache()

    # decode step time at 4 live slots on the filled cache
    num = eng.numerics
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    tok = torch.zeros((SLOTS, 1), dtype=torch.int64, device=dev)
    pos = torch.tensor(tick_lengths, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        step_ms = timed(lambda: tf.decode_step(params, tok, pos, eng.caches,
                                               cfg, num), iters=10)
    weight_ms = n_bytes / HBM_BPS * 1e3
    print(f"decode step (4 slots, positions {tick_lengths}, cache "
          f"{cache_len}): "
          f"{step_ms:.3f} ms; weight-streaming bound {weight_ms:.3f} ms "
          f"({n_bytes / 1e9:.2f} GB / {HBM_BPS / 1e12:.2f} TB/s)")
    with torch.inference_mode():
        prof = profile_steps(lambda: tf.decode_step(params, tok, pos,
                                                    eng.caches, cfg, num))
        longest = int(np.argmax(lengths))
        long_prompt = torch.as_tensor(prompts[longest], dtype=torch.int64,
                                      device=dev)[None]
        print(f"prefill of the {lengths[longest]}-token prompt:")
        prof_pre = profile_steps(lambda: tf.prefill(params, long_prompt, cfg,
                                                    num, cache_len), n=1)

    # first tokens against a plain-version prefill on the card
    plain = PlainFusedNumerics(lib)
    max_dlogit = 0.0
    ties = 0
    with torch.inference_mode():
        for rid, p in enumerate(prompts):
            first = streams["graph"][rid][0]
            t = torch.as_tensor(p, dtype=torch.int64, device=dev)[None]
            lp, _ = tf.prefill(params, t, cfg, plain, cache_len)
            lk, _ = tf.prefill(params, t, cfg, num, cache_len)
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
                eager_wall_s=walls.get("eager"),
                eager_tokens_per_s=(n_tok / walls["eager"] if "eager" in walls
                                    else None), ticks=ticks,
                n_layers=cfg.n_layers, cache_len=cache_len,
                lengths=list(lengths),
                decode_step_ms=step_ms, weight_bound_ms=weight_ms,
                decode_profile=prof, prefill_profile=prof_pre,
                per_forward=per, per_prefill=per_prefill, **main,
                peak_bytes=peak,
                max_dlogit=max_dlogit,
                first_token_ties=ties, caches_equal=same_cache,
                streams=streams["graph"])


def decode_roofline(cfg, lib, slots: int, cache_len: int) -> dict:
    """The served decode step of ``cfg`` (``slots`` rows at ``cache_len``,
    the library-bound fused numerics, one rank) profiled on fake CPU
    tensors (``launch.xprof.profile_step``; ``lib`` a CPU library): its
    FLOPs, HBM bytes, kernel launches, argument and temp bytes, and the
    compute and memory terms of its roofline on the card's datasheet
    rates (ms)."""
    import torch

    from repro_torch.launch.xprof import profile_step, tensor_bytes
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import spec
    from repro_torch.numerics.ops import FusedInterpNumerics

    num = FusedInterpNumerics(lib)
    args = (tf.param_shapes(cfg), spec((slots, 1), torch.int64),
            spec((slots,), torch.int32), tf.cache_shapes(cfg, slots,
                                                         cache_len))
    t0 = time.perf_counter()
    prof, _ = profile_step(lambda p, t, pos, c: tf.decode_step(
        p, t, pos, c, cfg, num), *args)
    compute_ms = prof.flops / BF16_FLOPS * 1e3
    memory_ms = prof.hbm_bytes / HBM_BPS * 1e3
    return dict(trace_s=time.perf_counter() - t0, flops=prof.flops,
                hbm_bytes=prof.hbm_bytes, compute_ms=compute_ms,
                memory_ms=memory_ms, bound_ms=max(compute_ms, memory_ms),
                bound_by="bytes" if memory_ms >= compute_ms else "operations",
                kernel_launches=dict(prof.kernel_launches),
                trip_counts=prof.trip_counts,
                argument_bytes=tensor_bytes(args),
                temp_bytes=prof.peak_live_bytes,
                cache_bytes=tensor_bytes(args[3]),
                top=prof.breakdown(8))


def roofline_phase(params, cfg, lib, dev, served: dict) -> dict:
    """The dry run's profiler held against the card. The served full-width
    Yi-6B decode step at the tick's shape (``SLOTS`` slots, cache
    ``CACHE_LEN``, interp-fused, one rank) profiled on fake tensors on the
    host (:func:`decode_roofline`, over a CPU copy of the library) beside
    the device ms a step that ``tick_profile`` measured on the graph
    engine. Fails unless the
    profile's HBM bytes cover the weights and the cache the step reads,
    its kernel launches per step equal the tick's counted launches per
    decode forward, the measured step is at least 0.95 x the roofline
    bound, and its argument bytes equal the parameters and cache the
    engine holds on the card. Then ``temp_bytes`` beside
    ``max_memory_allocated`` around one eager step, and one production
    cell (``yi_6b decode_32k pod16x16``) traced on the host."""
    import torch

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.xprof import tensor_bytes
    from repro_torch.models import transformer as tf

    from repro_torch.api.library import InterpLibrary

    # the profile runs on fake CPU tensors: the ROM it reads is a CPU copy
    with tempfile.TemporaryDirectory() as tmp:
        cpu_lib = InterpLibrary.load(lib.save(pathlib.Path(tmp) / "lib"),
                                     device="cpu")
    rl = decode_roofline(cfg, cpu_lib, SLOTS, CACHE_LEN)
    measured = served["ticks"]["graph"]["device_ms_per_step"]
    weights = served["n_bytes"]
    print(f"roofline of the served decode step ({SLOTS} slots, cache "
          f"{CACHE_LEN}; traced in {rl['trace_s']:.2f} s): "
          f"{rl['flops'] / 1e9:.3f} GFLOP, {rl['hbm_bytes'] / 1e9:.3f} GB "
          f"-> compute {rl['compute_ms']:.4f} ms, memory "
          f"{rl['memory_ms']:.4f} ms (bound by {rl['bound_by']}); measured "
          f"device {_ms(measured)} per step (tick_profile), weight bound "
          f"{served['weight_bound_ms']:.3f} ms; launches per step "
          f"{rl['kernel_launches']}")
    for row in rl["top"]:
        print(f"  {row['op']:>16s} {row['where'][:40]:40s} "
              f"{row['bytes'] / 1e9:8.4f} GB x{row['calls']}")
    # the weights the step reads: every leaf but the token table, of which
    # the embedding gathers one row per slot (Yi-6B's head is its own)
    tab = params["embed"]["tok"]
    read_w = (weights - tab.numel() * tab.element_size()
              + SLOTS * cfg.d_model * tab.element_size())
    if rl["hbm_bytes"] < read_w + rl["cache_bytes"]:
        raise AssertionError(f"profiled bytes {rl['hbm_bytes']} below the "
                             f"weights {read_w} + cache "
                             f"{rl['cache_bytes']} the step reads")
    want = {k: v for k, v in served["per_forward"].items() if v}
    if rl["kernel_launches"] != want:
        raise AssertionError(f"profiled launches {rl['kernel_launches']} != "
                             f"the tick's {want} per decode step")
    if measured is None:
        raise AssertionError("tick_profile measured no device time")
    if measured < 0.95 * rl["bound_ms"]:
        raise AssertionError(f"measured {measured} ms per step is below "
                             f"0.95 x the roofline bound {rl['bound_ms']} "
                             f"ms: the count is wrong")
    # what the engine holds on the card: its parameters, a cache of the
    # tick's shape and the slot tokens and positions the step reads
    caches = tf.init_cache(cfg, SLOTS, CACHE_LEN, dev)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int64, device=dev)
    pos = torch.tensor(TICK_PROMPTS, dtype=torch.int32, device=dev)
    held = tensor_bytes((params, tok, pos, caches))
    print(f"argument bytes {rl['argument_bytes']} (traced) vs {held} "
          f"held on the card (parameters {weights}, cache "
          f"{tensor_bytes(caches)})")
    if held != rl["argument_bytes"]:
        raise AssertionError("traced argument bytes differ from the "
                             "parameters and cache on the card")
    from repro_torch.numerics.ops import FusedInterpNumerics

    num = FusedInterpNumerics(lib)
    with torch.inference_mode():
        tf.decode_step(params, tok, pos, caches, cfg, num)  # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tf.decode_step(params, tok, pos, caches, cfg, num)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"temp bytes {rl['temp_bytes']} (traced peak of live "
          f"intermediates) vs {eager_peak} (max_memory_allocated above "
          f"the resident bytes around one eager step)")
    del caches
    t0 = time.perf_counter()
    cell = run_cell("yi_6b", "decode_32k")
    cell_s = time.perf_counter() - t0
    if cell["status"] != "ok":
        raise AssertionError(f"production cell: {cell}")
    prof = cell["profile"]
    print(f"production cell yi_6b decode_32k pod16x16 traced on the host in "
          f"{cell_s:.2f} s: {prof['flops'] / 1e9:.2f} GFLOP, "
          f"{prof['hbm_bytes'] / 1e9:.3f} GB, collectives "
          f"{prof['total_collective_bytes'] / 1e6:.2f} MB per rank; "
          f"argument bytes {cell['memory']['argument_bytes']}")
    return dict(rl, top=None, measured_device_ms=measured,
                weights_read_bytes=read_w,
                weight_bound_ms=served["weight_bound_ms"],
                ratio=measured / rl["bound_ms"], held_bytes=held,
                eager_peak_bytes=eager_peak, production_cell=dict(
                    trace_s=cell_s, flops=prof["flops"],
                    hbm_bytes=prof["hbm_bytes"],
                    collective_bytes=prof["total_collective_bytes"],
                    memory=cell["memory"]))


def yi_extra_phases(params, cfg, lib, seg_lib, dev, served=None) -> dict:
    """On the loaded Yi-6B weights: the roofline check of the dry run's
    profiler, the serial oracle, the card fault phase, the plan phase, and
    the AOT phase with the async host run."""
    return {"roofline": phase("roofline", roofline_phase, params, cfg, lib,
                              dev, served),
            "serial_oracle": phase("serial oracle", serial_oracle_phase,
                                   params, cfg, dev),
            "faults": phase("faults", fault_phase, params, cfg, lib, dev),
            "plans": phase("plans", plan_phase, params, cfg, lib, seg_lib,
                           dev),
            "aot": phase("aot yi_6b", aot_phase, params, cfg, lib, dev,
                         async_host=True),
            "mesh": phase("mesh", mesh_phase, params, cfg, lib, dev)}


# the mesh phase's train step: Yi-6B cut to MESH_TRAIN_LAYERS layers of
# the served weights, one global batch of MESH_TRAIN_BATCH x MESH_TRAIN_SEQ
MESH_TRAIN_LAYERS, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH = 8, 1024, 2


def deadline_journal_run(eng, prompts, path: pathlib.Path) -> dict:
    """The serve requests ``prompts`` through ``eng`` with deadlines
    (``deadline_s`` 100 s) on a ``FaultClock`` and a journal at ``path``:
    request 1 (live after the first admission) and request 5 (queued
    behind the four slots) carry an absolute deadline of 0.5 s, the clock
    advances 1 s after the first tick, and one more request past its
    deadline is rejected at submit. Returns every request's
    ``(rid, outcome, tick)`` in the order seen, the streams (the expired
    one's prefix included) and the journal's bytes; the engine's clock,
    TTL and journal are restored after."""
    from repro_torch.faults import FaultClock
    from repro_torch.serve.engine import Rejected, Request
    from repro_torch.serve.journal import ServeJournal

    saved = eng.clock, eng.deadline_s, eng.journal
    n_fin, n_fail = len(eng.finished), len(eng.failed)
    clock = FaultClock()
    eng.clock, eng.deadline_s, eng.journal = clock, 100.0, ServeJournal(path)
    events, seen = [], set()
    try:
        for i, p in enumerate(prompts):
            eng.submit(Request(2000 + i, p, max_new=MAX_NEW,
                               deadline=0.5 if i in (1, 5) else None))
        try:
            eng.submit(Request(2000 + len(prompts), prompts[0],
                               max_new=MAX_NEW, deadline=-1.0))
        except Rejected as e:
            events.append([2000 + len(prompts), e.reason, 0])
        for t in range(1000):
            if not (eng.queue or any(r is not None for r in eng.req)):
                break
            if t == 1:
                clock.advance(1.0)
            eng.step(HORIZON)
            for r in eng.failed[n_fail:] + eng.finished[n_fin:]:
                if r.rid not in seen:
                    seen.add(r.rid)
                    events.append([r.rid, r.error or "done",
                                   eng.stats["ticks"]])
        eng.journal.close()
    finally:
        eng.clock, eng.deadline_s, eng.journal = saved
    streams = {r.rid: list(r.out)
               for r in eng.finished[n_fin:] + eng.failed[n_fail:]}
    outcomes = {(rid, what) for rid, what, _t in events}
    want = {(2000 + len(prompts), "deadline"), (2001, "deadline_exceeded"),
            (2005, "deadline_exceeded")}
    if not want <= outcomes or len(events) != len(prompts) + 1:
        raise AssertionError(f"deadline run: outcomes {events}, want "
                             f"{sorted(want)} among them")
    return dict(events=events, streams=streams, journal=path.read_bytes(),
                agreements=eng.stats["agreements"])


def mesh_phase(params, cfg, lib, dev) -> dict:
    """Distribution at world 1 on the card: one NCCL rank (a
    file store, ``device_id`` cuda:0), every collective still issued and
    captured in the graphs.

    (a) The served full-width Yi-6B weights through an unmeshed AOT graph
    engine and through ``ServeEngine(mesh=make_serve_mesh(1, 1),
    aot_buckets=True)`` on the 6 serve requests: streams, caches and
    kernel launches bitwise equal (the counts set to 0 just before each
    run, read just after), the meshed tick graphs holding their
    collectives (counted at capture: ``2 * n_layers + 1`` all-reduces and
    2 all-gathers per step); the 6 requests again with deadlines on a
    ``FaultClock`` that expires one live and one queued request, and a
    journal (:func:`deadline_journal_run`): outcomes with their ticks,
    streams and journal bytes equal between the two engines, the meshed
    one agreeing on its clock; then each engine's tick at 4 live slots
    (wall ms per step, tokens/s, device ms and busy share), without and
    with deadlines on the host clock (the meshed one's retire pass then
    agrees on its clock once a tick).
    (b) One train step of Yi-6B at ``MESH_TRAIN_LAYERS`` layers (the first
    layers of the served weights, exact numerics) unmeshed and on a
    ``1 x 1`` ``data x model`` mesh from the same parameters: the loss
    bitwise equal, grad_norm within 1e-5 relative (the index backward
    accumulates in no fixed order).
    (c) The fleet's probe split: ``fleet_region_envelopes_device`` with
    ``shards=2`` (capped to the one card) and with two chunks on the card
    (``devices=[cuda:0, cuda:0]``: the sentinel pad and the concatenation)
    bitwise ``shards=1``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import fleet
    from repro_torch.core.funcspec import get_spec
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import build
    from repro_torch.kernels.dspace.ops import fleet_region_envelopes_device
    from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh
    from repro_torch.models.layers import map_tree
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.step import (StepConfig, TrainState,
                                        make_train_step, shard_state)

    store = tempfile.mkdtemp(prefix="mesh_phase_")
    jdir = pathlib.Path(store)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=300))
    out: dict = {}
    try:
        mesh = make_serve_mesh(1, 1)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in SERVE_LENGTHS]
        kw = dict(slots=SLOTS, cache_len=CACHE_LEN, horizon=HORIZON,
                  device=dev, library=lib, aot_buckets=True, max_pack=4)
        per_step = {"all_reduce": 2 * cfg.n_layers + 1, "all_gather": 2,
                    "reduce_scatter": 0}
        ref_caches = None
        for name, extra in (("unmeshed", {}), ("meshed", {"mesh": mesh})):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            eng = ServeEngine(cfg, params, **kw, **extra)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            if not eng.stats["graph"]:
                raise AssertionError(f"mesh {name}: "
                                     f"{eng.stats['graph_reason']}")
            _serve_requests(eng, prompts)
            streams, wall, wrappers = _run_timed(eng)
            res = dict(build_s=build_s, capture_s=eng.stats["capture_s"],
                       captures=eng.stats["captures"], wall_s=wall,
                       tokens_per_s=len(prompts) * MAX_NEW / wall,
                       launches=dict(eng.stats["launches"]),
                       wrapper_launches=wrappers,
                       collectives=dict(eng.stats["collectives"]),
                       aot_misses=eng.stats["aot_misses"])
            if name == "unmeshed":
                want = streams
                ref_caches = [t.clone() for t in tf.cache_leaves(eng.caches)]
                ref_launches = res["launches"]
            else:
                if streams != want:
                    raise AssertionError(f"meshed streams {streams} != "
                                         f"unmeshed {want}")
                if res["launches"] != ref_launches:
                    raise AssertionError(f"meshed launches "
                                         f"{res['launches']} != unmeshed "
                                         f"{ref_launches}")
                if not all(torch.equal(a, b) for a, b in zip(
                        ref_caches, tf.cache_leaves(eng.caches))):
                    raise AssertionError("meshed caches differ")
                for steps, (_g, _l, coll) in eng._graphs.items():
                    if coll != {k: n * steps for k, n in per_step.items()}:
                        raise AssertionError(f"tick graph {steps}: "
                                             f"collectives {coll}, want "
                                             f"{per_step} per step")
                res["tick_graph_collectives"] = {
                    str(k): v[2] for k, v in eng._graphs.items()}
                if not res["collectives"]["all_reduce"]:
                    raise AssertionError("no collective ran")
                ref_caches = None
            dl = deadline_journal_run(eng, prompts, jdir / f"{name}.jsonl")
            if name == "unmeshed":
                want_dl = dl
                if dl["agreements"]:
                    raise AssertionError("an unmeshed engine agreed")
            else:
                for key in ("events", "streams", "journal"):
                    if dl[key] != want_dl[key]:
                        raise AssertionError(
                            f"deadline run: meshed {key} differ from the "
                            f"unmeshed engine's")
                if not dl["agreements"]:
                    raise AssertionError("the meshed engine never agreed "
                                         "on its clock")
            res["deadlines"] = dict(events=dl["events"],
                                    journal_bytes=len(dl["journal"]),
                                    agreements=dl["agreements"])
            print(f"mesh phase {name} deadlines: outcomes {dl['events']}; "
                  f"journal {len(dl['journal'])} bytes; agreements "
                  f"{dl['agreements']}")
            res["tick"] = tick_profile(eng, cfg, n=3, n_prof=1)
            res["tick"].pop("profile", None)
            eng.run()  # the tick profile's requests run out
            eng.deadline_s = 3600.0  # on the host clock: none expires
            agreed = eng.stats["agreements"]
            res["tick_deadlines"] = tick_profile(eng, cfg, n=3, n_prof=1)
            res["tick_deadlines"].pop("profile", None)
            res["tick_deadlines"]["agreements"] = (eng.stats["agreements"]
                                                   - agreed)
            eng.run()
            eng.deadline_s = None
            out[name] = res
            print(f"mesh phase {name}: built in {build_s:.2f} s "
                  f"({res['captures']} graphs), 6 requests {wall:.3f} s = "
                  f"{res['tokens_per_s']:.2f} tokens/s; tick "
                  f"{res['tick']['wall_ms_per_step']:.3f} ms wall per step "
                  f"({res['tick']['tokens_per_s']:.1f} tokens/s), with "
                  f"deadlines {res['tick_deadlines']['wall_ms_per_step']:.3f}"
                  f" ms ({res['tick_deadlines']['agreements']} agreements); "
                  f"collectives {res['collectives']}")
            eng.close()
            del eng
        out["streams_equal"] = True

        # (b) the train step at MESH_TRAIN_LAYERS layers, bitwise loss
        cfg8 = cfg.replace(n_layers=MESH_TRAIN_LAYERS, numerics="exact")
        p8 = {**params, "segments": map_tree(
            lambda _n, t: t[:MESH_TRAIN_LAYERS], params["segments"])}
        batch = make_batch(cfg8, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH)
        sc = StepConfig(peak_lr=1e-4, warmup=0)
        opt = adamw_init(p8)
        metrics = {}
        for name in ("unmeshed", "meshed"):
            gc.collect()
            torch.cuda.empty_cache()
            m = make_host_mesh(1) if name == "meshed" else None
            state = TrainState(p8, opt, None)  # the loss reads only p8
            if m is not None:
                state = shard_state(state, cfg8, m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, met = make_train_step(cfg8, sc, donate=True, mesh=m)(
                state, batch, 0)
            torch.cuda.synchronize()
            metrics[name] = {"loss": met["loss"].clone(),
                             "grad_norm": float(met["grad_norm"]),
                             "step_s": time.perf_counter() - t0}
            del new, met, state
        lu, lm = metrics["unmeshed"]["loss"], metrics["meshed"]["loss"]
        gu = metrics["unmeshed"]["grad_norm"]
        gm = metrics["meshed"]["grad_norm"]
        if not torch.equal(lu, lm):
            raise AssertionError(f"meshed train loss {float(lm)!r} != "
                                 f"unmeshed {float(lu)!r}")
        if abs(gm - gu) > 1e-5 * abs(gu):
            raise AssertionError(f"grad_norm {gm} vs {gu}")
        out["train"] = {k: {**v, "loss": float(v["loss"])}
                        for k, v in metrics.items()}
        del opt, p8
        print(f"mesh phase train step ({MESH_TRAIN_LAYERS} layers, "
              f"{MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ}): loss "
              f"{float(lu)!r} bitwise, grad_norm {gu!r} / {gm!r}; "
              f"{metrics['unmeshed']['step_s']:.2f} / "
              f"{metrics['meshed']['step_s']:.2f} s")

        # (c) the fleet's probe split on the one card
        pairs = [("recip", 12, 5), ("exp2", 12, 5), ("silu", 12, 5)]
        stack = fleet.stack_bounds([get_spec(k, b).region_bounds(r)
                                    for k, b, r in pairs])
        before = dict(build.LAUNCHES)
        one = fleet_region_envelopes_device(stack.L, stack.U, shards=1,
                                            device=dev)
        for label, kw2 in (("shards=2", {"shards": 2}),
                           ("two chunks", {"shards": 2,
                                           "devices": [dev, dev]})):
            got = fleet_region_envelopes_device(stack.L, stack.U,
                                                device=dev, **kw2)
            if not all(np.array_equal(a, b, equal_nan=True)
                       for a, b in zip(one, got)):
                raise AssertionError(f"fleet split {label} differs")
        torch.cuda.synchronize()
        out["fleet_rows"] = int(one[0].shape[0])
        out["fleet_launches"] = {k: n - before[k]
                                 for k, n in build.LAUNCHES.items()}
        if out["fleet_launches"]["envelopes_parity_fleet"] != 4:
            raise AssertionError(f"fleet split launches "
                                 f"{out['fleet_launches']}: want 1 + 1 + 2")
    finally:
        dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[:1]
    u, m = out["unmeshed"]["tick"], out["meshed"]["tick"]
    out["card"] = smi[0] if smi else None
    ud, md = out["unmeshed"]["tick_deadlines"], out["meshed"]["tick_deadlines"]
    print(f"mesh phase on {out['card']}: tick wall ms per step with "
          f"deadlines {ud['wall_ms_per_step']:.3f} unmeshed / "
          f"{md['wall_ms_per_step']:.3f} meshed, device "
          f"{_ms(ud['device_ms_per_step'])} / "
          f"{_ms(md['device_ms_per_step'])}")
    print(f"mesh phase on {out['card']}: tick wall ms per step "
          f"{u['wall_ms_per_step']:.3f} unmeshed / "
          f"{m['wall_ms_per_step']:.3f} meshed (world-1 NCCL), "
          f"{u['tokens_per_s']:.1f} / {m['tokens_per_s']:.1f} tokens/s; "
          f"6 requests {out['unmeshed']['tokens_per_s']:.2f} / "
          f"{out['meshed']['tokens_per_s']:.2f} tokens/s end to end")
    return out


def serial_oracle_phase(params, cfg, dev, lengths=SERVE_LENGTHS) -> dict:
    """The serial path (one decode forward and a host argmax per token)
    against the graph tick, both with exact numerics, on the 6 serve
    requests (prompts of ``lengths`` tokens): bitwise equal streams."""
    import torch

    from repro_torch.serve.engine import ServeEngine

    cfg = cfg.replace(numerics="exact")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
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


def launches_by_library(fn, libs: dict):
    """Run ``fn()``; return its result and the served kernels' launches in
    it by the slot library whose ROM each read, ``{slot key: {kernel: n}}``,
    as the wrappers count them at the launch site
    (``build.LAUNCHES_BY_ROM``)."""
    from repro_torch.kernels import build

    names = {lib.coeffs.data_ptr(): k for k, lib in libs.items()}
    before = dict(build.LAUNCHES_BY_ROM)
    out = fn()
    counts: dict = {}
    for (kernel, ptr), n in build.LAUNCHES_BY_ROM.items():
        n -= before.get((kernel, ptr), 0)
        if n:
            counts.setdefault(names.get(ptr, "?"), {})[kernel] = n
    return out, counts


def three_slot_plan(n_layers: int):
    """Layer 0 on an R5 slot, layer 1 on the segmented (hier) slot, every
    other layer and ``rest`` on the default slot; all interp-fused."""
    from repro_torch.plan import (LayerAssign, NumericsPlan, SiteAssign,
                                  SlotSpec)

    def la(slot):
        return LayerAssign(*(SiteAssign("interp-fused", slot),) * 3)
    rest = la(SlotSpec())
    return NumericsPlan(
        layers=(la(SlotSpec(lookup_bits=5)), la(SlotSpec(
            segmentation="hier"))) + (rest,) * (n_layers - 2), rest=rest)


def plan_phase(params, cfg, lib, seg_lib, dev) -> dict:
    """Per-layer numerics plans at full width, on the loaded weights: a
    uniform interp-fused plan against the homogeneous graph engine (token
    streams and final caches bitwise); a three-slot plan (R5 layer 0,
    segmented layer 1, default elsewhere) through the graph tick, with its
    launches per forward per slot library and its first tokens against
    the plain versions; and a ROM flip in the R5 slot mid-run, which must
    take layer 0 and only layer 0 to exact, recapture and finish."""
    import torch

    from repro_torch.api import Explorer, ExploreConfig
    from repro_torch.faults import flip_rom_bit
    from repro_torch.models import transformer as tf
    from repro_torch.plan import NumericsPlan
    from repro_torch.plan.numerics import PlanNumerics
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_LENGTHS]
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, horizon=HORIZON, device=dev)
    res = {}

    # a uniform plan is the homogeneous engine, bitwise
    runs = {}
    uniform = cfg.replace(plan=NumericsPlan.uniform("interp-fused",
                                                    cfg.n_layers))
    for name, c, library in (("homogeneous", cfg, lib),
                             ("uniform plan", uniform, {"default": lib})):
        eng = ServeEngine(c, params, library=library, **kw)
        if not eng.stats["graph"]:
            raise AssertionError(f"{name}: {eng.stats['graph_reason']}")
        _serve_requests(eng, prompts)
        streams, wall, _ = _run_timed(eng)
        runs[name] = (streams, eng.caches, wall)
        del eng
    same_cache = [bool(torch.equal(a, b)) for a, b in
                  zip(runs["homogeneous"][1], runs["uniform plan"][1])]
    same = runs["homogeneous"][0] == runs["uniform plan"][0]
    print(f"uniform interp-fused plan vs the homogeneous graph engine: "
          f"streams equal {same}, caches k, v, pos equal {same_cache} "
          f"({runs['uniform plan'][2]:.2f} s / "
          f"{runs['homogeneous'][2]:.2f} s)")
    if not (same and all(same_cache)):
        raise AssertionError("the uniform plan is not the homogeneous "
                             "engine bitwise")
    res["uniform"] = dict(streams_equal=True, caches_equal=same_cache,
                          wall_s=runs["uniform plan"][2],
                          homogeneous_wall_s=runs["homogeneous"][2])
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    # the three-slot plan
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        r5 = Explorer(ExploreConfig(device=str(dev), cache_dir=d)).compile(
            lookup_bits=5)
    print(f"R5 library {r5.rom_sha()} {tuple(r5.coeffs.shape)} generated on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    libs = {"R5": r5, "hier": seg_lib, "default": lib}
    plan = three_slot_plan(cfg.n_layers)
    c = cfg.replace(plan=plan)
    t0 = time.perf_counter()
    eng, built_by_lib = launches_by_library(
        lambda: ServeEngine(c, params, library=dict(libs), **kw), libs)
    build_s = time.perf_counter() - t0
    if not eng.stats["graph"]:
        raise AssertionError(f"plan engine: {eng.stats['graph_reason']}")
    _serve_requests(eng, prompts)
    streams, wall, wrappers = _run_timed(eng)
    per = per_forward(cfg)
    forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
    expected = {k: n * forwards for k, n in per.items()}
    if (eng.stats["launches"] != expected or wrappers !=
            {k: n * eng.stats["prefills"] for k, n in per.items()}):
        raise AssertionError(f"plan engine launches {eng.stats['launches']}"
                             f" / {wrappers}, expected {expected}")
    if sorted(streams) != list(range(len(prompts))) or any(
            len(v) != MAX_NEW for v in streams.values()):
        raise AssertionError(f"plan engine streams {streams}")
    # launches of one eager forward, by the library each kernel read; the
    # engine's construction (warm-up and graph captures) must read each
    # library in the same proportion, a whole number of forwards
    t = torch.as_tensor(prompts[0], dtype=torch.int64, device=dev)[None]
    with torch.inference_mode():
        _, by_lib = launches_by_library(
            lambda: tf.prefill(params, t, c, eng.numerics, CACHE_LEN), libs)
    one = {"rmsnorm_lib": 2, "flash_attn_lib": 1, "act_lib": 1}
    want_by_lib = {"R5": one, "hier": one,
                   "default": {"rmsnorm_lib": 2 * (cfg.n_layers - 2) + 1,
                               "flash_attn_lib": cfg.n_layers - 2,
                               "act_lib": cfg.n_layers - 2}}
    built_forwards = built_by_lib.get("R5", {}).get("flash_attn_lib", 0)
    want_built = {k: {kernel: n * built_forwards for kernel, n in v.items()}
                  for k, v in want_by_lib.items()}
    print(f"three-slot plan (R5 / hier / default): built in {build_s:.2f} s "
          f"({eng.stats['captures']} graphs, {eng.stats['capture_s']:.2f} "
          f"s); 6 requests {wall:.2f} s, {96 / wall:.2f} tokens/s; launches "
          f"{eng.stats['launches']} = per forward x {forwards}; "
          f"launches by library (counted at the launch site): one eager "
          f"forward {by_lib}, the construction's warm-up and captures "
          f"{built_by_lib} ({built_forwards} forwards)")
    if by_lib != want_by_lib:
        raise AssertionError(f"launches by library {by_lib} != "
                             f"{want_by_lib}")
    if not built_forwards or built_by_lib != want_built:
        raise AssertionError(f"construction launches by library "
                             f"{built_by_lib} != {want_built}")
    # first tokens against the plain versions under the same plan
    plain = PlanNumerics(plan, libs, plain=True)
    ties, max_dlogit = 0, 0.0
    with torch.inference_mode():
        for rid, p in enumerate(prompts):
            t = torch.as_tensor(p, dtype=torch.int64, device=dev)[None]
            lk, _ = tf.prefill(params, t, c, eng.numerics, CACHE_LEN)
            lp, _ = tf.prefill(params, t, c, plain, CACHE_LEN)
            lk, lp = lk[0, -1].float(), lp[0, -1].float()
            first = streams[rid][0]
            if int(lk.argmax()) != first:
                raise AssertionError(f"plan request {rid}: first token "
                                     f"{first} != its own prefill")
            max_dlogit = max(max_dlogit, float((lk - lp).abs().max()))
            gap = float(lp.max() - lp[first])
            if gap > 0:
                ties += 1
                if gap > 2.0 ** -5 * float(lp.abs().max()):
                    raise AssertionError(f"plan request {rid}: {gap}")
    print(f"three-slot plan first tokens vs plain versions: "
          f"{len(prompts) - ties} equal, {ties} inside the tie band; max "
          f"|dlogit| {max_dlogit:.4f}")
    res["three_slot"] = dict(
        build_s=build_s, captures=eng.stats["captures"],
        capture_s=eng.stats["capture_s"], wall_s=wall,
        tokens_per_s=96 / wall, launches=dict(eng.stats["launches"]),
        forwards=forwards, launches_by_library=by_lib,
        construction_launches_by_library=built_by_lib,
        construction_forwards=built_forwards,
        first_token_ties=ties, max_dlogit=max_dlogit,
        r5_rom_sha=r5.rom_sha())
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # a ROM flip in the R5 slot mid-run
    eng = ServeEngine(c, params, library=dict(libs), verify_rom_every=1,
                      **kw)
    _serve_requests(eng, prompts[:3], max_new=8)
    eng.step(HORIZON)
    n_cap = eng.stats["captures"]
    eng.library["R5"] = flip_rom_bit(libs["R5"], seed=3)
    eng.run()
    torch.cuda.synchronize()
    fault = next((f for f in eng.faults if f["reason"] == "rom_integrity"),
                 None)
    new = eng.cfg.plan
    done = {r.rid: len(r.out) for r in eng.finished}
    print(f"R5 ROM flip mid-run: faults {eng.faults}; degradations "
          f"{eng.stats['degradations']}; captures {n_cap} -> "
          f"{eng.stats['captures']}; finished {done}; graph "
          f"{eng.stats['graph']}")
    if not (fault and fault["action"] == "slots:R5->exact"
            and fault["layers"] == ("0",)
            and eng.stats["degradations"] == {"0": 1}
            and new.layers[0].uniform_backend == "exact"
            and all(la.uniform_backend == "interp-fused"
                    for la in new.layers[1:])
            and eng.fused and eng.stats["graph"]
            and eng.stats["captures"] > n_cap
            and sorted(eng.library) == ["default", "hier"]
            and done == {0: 8, 1: 8, 2: 8} and not eng.failed):
        raise AssertionError("the R5 flip did not take layer 0 alone to "
                             "exact")
    res["rom_flip"] = dict(faults=eng.faults,
                           degradations=eng.stats["degradations"],
                           captures=[n_cap, eng.stats["captures"]])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def divergences(params, cfg, lib, prompts, want, got, dev) -> dict:
    """``{rid: (step, top-2 gap, tie band)}`` at each stream's first
    divergence of ``got`` from ``want``: the gap of the kernels' own logits
    after an exact-length prefill of the shared prefix, beside the tie band
    2^-5 max|logit|."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import get_numerics

    num = get_numerics(cfg, lib)
    out = {}
    with torch.inference_mode():
        for rid in want:
            t = next((i for i, (x, y) in enumerate(zip(want[rid], got[rid]))
                      if x != y), None)
            if t is None:
                continue
            seq = np.concatenate([prompts[rid],
                                  np.asarray(want[rid][:t], np.int32)])
            lk, _ = tf.prefill(params, torch.as_tensor(
                seq, dtype=torch.int64, device=dev)[None], cfg, num,
                CACHE_LEN)
            lk = lk[0, -1].float()
            top2 = torch.topk(lk, 2).values
            out[rid] = (t, float(top2[0] - top2[1]),
                        2.0 ** -5 * float(lk.abs().max()))
    return out


AOT_GROUP2 = (40, 48, 56, 64)  # a second group: one bucket (64), one pack


def aot_phase(params, cfg, lib, dev, async_host: bool = False) -> dict:
    """The AOT tier at full width on the loaded weights: the 6 serve
    requests, then a second group of 4 same-bucket prompts, through the
    graph-only engine and through ``aot_buckets=True, max_pack=4`` (a
    CUDA graph per (bucket, pack)) in the same call: capture seconds, peak
    memory, tokens/s end to end, zero misses, packed requests; each
    admission's first tokens against the plain ``prefill_padded`` of its
    packed group (the tie band); Yi-6B's streams against the graph-only
    engine's (tie band at a first divergence); the busy share of a packed
    admission replay. With ``async_host``: the same AOT run on the host
    pipeline (streams bitwise the synchronous AOT run's) and a journaled
    async run stopped mid-run and resumed to the same streams."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import PlainFusedNumerics
    from repro_torch.serve import aot
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.journal import load_requests

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_LENGTHS]
    group2 = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
              for n in AOT_GROUP2]
    allp = prompts + group2
    kw = dict(slots=SLOTS, cache_len=CACHE_LEN, horizon=HORIZON, device=dev,
              library=lib)
    per = per_forward(cfg)
    res, streams = {}, {}

    def build_engine(name, **extra):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params, **kw, **extra)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated(dev) - base
        peak = torch.cuda.max_memory_allocated(dev) - base
        if not eng.stats["graph"]:
            raise AssertionError(f"{name}: {eng.stats['graph_reason']}")
        return eng, dict(build_s=build_s, captures=eng.stats["captures"],
                         capture_s=eng.stats["capture_s"],
                         held_bytes=held, peak_build_bytes=peak)

    for name, extra in (("graph", {}),
                        ("aot", dict(aot_buckets=True, max_pack=4))):
        eng, info = build_engine(name, **extra)
        log = []
        if name == "aot":
            real = eng._admit_packed

            def logged(sub, bucket, _real=real):
                log.append(([r.rid for r, _s in sub], bucket))
                return _real(sub, bucket)
            eng._admit_packed = logged
        _serve_requests(eng, prompts)
        s1, wall1, w1 = _run_timed(eng)
        st1 = dict(eng.stats)
        _serve_requests(eng, group2, rid0=len(prompts))
        s2, wall2, w2 = _run_timed(eng)
        peak = torch.cuda.max_memory_allocated(dev)
        forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
        expected = {k: n * forwards for k, n in per.items()}
        eager = eng.stats["prefills"] - eng.stats["admit_replays"]
        wrappers = {k: w1[k] + w2[k] for k in w1}
        if (eng.stats["launches"] != expected
                or wrappers != {k: n * eager for k, n in per.items()}):
            raise AssertionError(f"{name}: launches {eng.stats['launches']}"
                                 f" / {wrappers}, expected {expected}")
        out = {**s1, **s2}
        if sorted(out) != list(range(len(allp))) or any(
                len(v) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                             for t in v)
                for v in out.values()):
            raise AssertionError(f"{name}: bad streams {out}")
        streams[name] = out
        info.update(wall_s=wall1, tokens_per_s=96 / wall1,
                    group2_wall_s=wall2,
                    group2_tokens_per_s=len(group2) * MAX_NEW / wall2,
                    peak_bytes=peak, launches=dict(eng.stats["launches"]),
                    wrapper_launches=wrappers, forwards=forwards,
                    stats={k: eng.stats[k] for k in (
                        "aot_compiles", "aot_hits", "aot_misses",
                        "aot_fallbacks", "packed_admits", "packed_requests",
                        "admit_dispatches", "admit_replays", "prefills",
                        "ticks", "decode_steps")},
                    stats_after_6=({k: st1[k] for k in (
                        "aot_hits", "aot_misses", "packed_admits",
                        "packed_requests")} if name == "aot" else None))
        print(f"{cfg.name} {name} engine: built in {info['build_s']:.2f} s "
              f"({info['captures']} graphs captured in "
              f"{info['capture_s']:.2f} s; {info['held_bytes'] / 1e9:.3f} "
              f"GB held, {info['peak_build_bytes'] / 1e9:.3f} GB peak over "
              f"the weights during construction); 6 requests "
              f"{wall1:.3f} s = {96 / wall1:.2f} tokens/s end to end; "
              f"group of {len(group2)} x bucket 64: {wall2:.3f} s; peak "
              f"memory {peak / 1e9:.2f} GB; stats {info['stats']}")
        if name == "aot":
            s = eng.stats
            n_cap = aot.compile_count(eng.aot_buckets, 4, SLOTS, HORIZON)
            if not (s["aot_misses"] == 0 and s["aot_hits"] > 0
                    and s["aot_compiles"] == n_cap == s["captures"]
                    and s["packed_requests"] == len(allp)
                    and s["admit_replays"] == s["packed_admits"]
                    and any(len(rids) == 4 for rids, _b in log)):
                raise AssertionError(f"aot counters {s}, groups {log}")
            info["groups"] = log
            # first tokens of each packed group against the plain
            # prefill_padded of that group
            plain = PlainFusedNumerics(lib)
            ties, max_dl = 0, 0.0
            with torch.inference_mode():
                for rids, bucket in log:
                    toks = np.zeros((len(rids), bucket), np.int64)
                    for i, rid in enumerate(rids):
                        toks[i, :len(allp[rid])] = allp[rid]
                    lens = [len(allp[rid]) for rid in rids]
                    lp, _ = tf.prefill_padded(
                        params, torch.as_tensor(toks, device=dev),
                        torch.as_tensor(lens, device=dev), cfg, plain,
                        CACHE_LEN)
                    lk, _ = tf.prefill_padded(
                        params, torch.as_tensor(toks, device=dev),
                        torch.as_tensor(lens, device=dev), cfg,
                        eng.numerics, CACHE_LEN)
                    for i, rid in enumerate(rids):
                        first = out[rid][0]
                        lpi, lki = lp[i, 0].float(), lk[i, 0].float()
                        if int(lki.argmax()) != first:
                            raise AssertionError(
                                f"aot request {rid}: first token {first} "
                                f"!= its eager packed prefill")
                        max_dl = max(max_dl, float((lki - lpi).abs().max()))
                        gap = float(lpi.max() - lpi[first])
                        if gap > 0:
                            ties += 1
                            if gap > 2.0 ** -5 * float(lpi.abs().max()):
                                raise AssertionError(f"aot request {rid}: "
                                                     f"gap {gap}")
            print(f"packed first tokens vs the plain prefill_padded of "
                  f"each group {log}: {len(allp) - ties} equal, {ties} in "
                  f"the tie band; max |dlogit| {max_dl:.4f}")
            info.update(first_token_ties=ties, max_dlogit=max_dl)
            # one packed admission, replayed and eager: wall ms on the host
            # clock (each call ends in its first-token download), device ms
            # from the profiler, busy = device / wall. The engine is idle:
            # the admissions write free slots, which are not read again.
            prof = {}
            for bucket, pk in ((eng.aot_buckets.buckets[-1], 1), (64, 4)):
                host = np.zeros(pk * bucket + 2 * pk, np.int64)
                p_, l_, s_ = eng._admit_views(host, bucket, pk)
                for i in range(pk):
                    p_[i] = rng.integers(0, cfg.vocab_size, bucket)
                    l_[i], s_[i] = bucket, i
                inp = torch.as_tensor(host, device=dev)
                firsts = torch.empty(pk, dtype=torch.int64, device=dev)

                def eager(_inp=inp, _f=firsts, _b=bucket, _pk=pk):
                    with torch.inference_mode():
                        eng._admit_body(*eng._admit_views(_inp, _b, _pk),
                                        _f, eng.caches, eng._tok, eng._pos,
                                        eng._live)
                    return _f.cpu()
                for mode, call in (("replay", lambda _fn=eng._packed_fn(
                        bucket, pk), _h=host: _fn(_h).cpu()),
                                   ("eager", eager)):
                    call()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(5):
                        call()
                    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
                    print(f"packed admission, bucket {bucket} x {pk}, "
                          f"{mode}: {wall_ms:.3f} ms wall per call")
                    pr = profile_steps(call, n=2)
                    dev_ms = pr.get("device_ms")
                    busy = None if dev_ms is None else dev_ms / wall_ms
                    prof[f"{bucket}x{pk} {mode}"] = dict(
                        wall_ms=wall_ms, device_ms=dev_ms, busy_share=busy,
                        profile=pr)
                    print(f"  busy share {_share(busy)} (device "
                          f"{_ms(dev_ms)})")
            info["admit_profile"] = prof
        res[name] = info
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the AOT engine against the graph-only engine
    g, a = streams["graph"], streams["aot"]
    gaps = divergences(params, cfg, lib, allp, g, a, dev)
    print(f"{cfg.name} AOT vs graph-only streams: {len(g) - len(gaps)} of "
          f"{len(g)} equal; divergences (step, top-2 gap, tie band) {gaps}; "
          f"tokens/s {res['aot']['tokens_per_s']:.2f} vs "
          f"{res['graph']['tokens_per_s']:.2f} "
          f"({res['aot']['tokens_per_s'] / res['graph']['tokens_per_s']:.2f}"
          f"x)")
    if cfg.moe is None and any(gap > band for _t, gap, band in gaps.values()):
        raise AssertionError(f"AOT streams outside the tie band: {gaps}")
    res["streams_equal"] = not gaps
    res["divergences"] = gaps
    if not async_host:
        return res

    # the host pipeline on the same AOT engine configuration
    eng, info = build_engine("aot async", aot_buckets=True, max_pack=4,
                             async_host=True)
    _serve_requests(eng, prompts)
    s1, wall1, _ = _run_timed(eng)
    _serve_requests(eng, group2, rid0=len(prompts))
    s2, _, _ = _run_timed(eng)
    eng.close()
    out = {**s1, **s2}
    print(f"{cfg.name} aot + async host: 6 requests {wall1:.3f} s = "
          f"{96 / wall1:.2f} tokens/s; streams equal to the synchronous AOT "
          f"run {out == streams['aot']}; async chunks "
          f"{eng.stats['async_chunks']}, tokens {eng.stats['async_tokens']}")
    if out != streams["aot"]:
        raise AssertionError("async host streams differ from the sync run")
    info.update(wall_s=wall1, tokens_per_s=96 / wall1,
                async_chunks=eng.stats["async_chunks"],
                async_tokens=eng.stats["async_tokens"])
    del eng
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        jp = str(pathlib.Path(d) / "serve.jsonl")
        eng, _ = build_engine("aot async journaled", aot_buckets=True,
                              max_pack=4, async_host=True, journal=jp)
        _serve_requests(eng, prompts)
        for _ in range(3):
            eng.step(HORIZON)
        eng.close()
        del eng
        pre = {rid: len(st.out) for rid, st in load_requests(jp).items()}
        gc.collect()
        torch.cuda.empty_cache()
        res_eng = ServeEngine.resume(jp, cfg, params, **kw,
                                     aot_buckets=True, max_pack=4,
                                     async_host=True)
        res_eng.run()
        res_eng.close()
        final = {rid: st.out for rid, st in load_requests(jp).items()}
    want = {rid: streams["aot"][rid] for rid in range(len(prompts))}
    # a resumed slot is rebuilt by an exact-length prefill (its packed
    # group is not in the journal): other GEMM shapes than the packed
    # admission's, so the continuation is held to the tie band
    gaps = divergences(params, cfg, lib, prompts, want, final, dev)
    kept = all(final[rid][:n] == want[rid][:n] for rid, n in pre.items())
    print(f"async journal stopped after 3 ticks (durable tokens {pre}), "
          f"resumed ({res_eng.stats['resumed']} in flight): durable "
          f"prefixes kept {kept}; streams equal to the uninterrupted AOT "
          f"run {final == want}; divergences {gaps}")
    if (not kept or not res_eng.stats["resumed"]
            or any(len(v) != MAX_NEW for v in final.values())
            or any(gap > band for _t, gap, band in gaps.values())):
        raise AssertionError(f"async resume: {final} != {want}")
    info.update(resume=dict(durable=pre, resumed=res_eng.stats["resumed"],
                            streams_equal=final == want, divergences=gaps))
    res["async"] = info
    del res_eng
    gc.collect()
    torch.cuda.empty_cache()
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


# Mixtral-8x22B's run: the slot cache is its 4096-token window; two prompts
# past or near it (decode wraps the ring), two short ones; the tick at 4
# live slots on rings that have wrapped
MIXTRAL_LENGTHS = (4104, 4090, 200, 17)
MIXTRAL_TICK = (4104, 4200, 4300, 4500)
# depth cuts: full width, fewer layers, so the weights fit one 80 GB card
# beside the rest of the run (PERF.md §4)
MIXTRAL_LAYERS, QWEN_LAYERS = 8, 4
# DeepSeekMoE's dense layer 0 and 13 of its 27 MoE layers (full width): a
# depth cut that keeps the whole run inside half its time limit
DEEPSEEK_LAYERS = 14
# the SSM runs: a prompt longer than the 256-token SSD chunk must be a
# whole number of chunks (the reference's contract), so 512 stands for
# SERVE_LENGTHS' 511 and the tick's prompts are 256 / 512
SSM_LENGTHS = (17, 64, 200, 512, 33, 128)
SSM_TICK = (256, 512, 256, 512)
# Jamba at full width, one period of its 32 layers (7 Mamba, 1 attention,
# 4 MoE, 4 dense MLP): the whole model (~103 GB of bf16) does not fit one
# card
JAMBA_LAYERS = 8


def _gap(logits, tok: int) -> tuple[float, float]:
    """How far ``tok`` trails the argmax of one row of plain-version
    logits, and the 2^-5 max|logit| tie band it must stay inside."""
    import torch

    lf = logits.float()
    if not torch.isfinite(lf).all():
        raise AssertionError("non-finite logits")
    return float(lf.max() - lf[tok]), 2.0 ** -5 * float(lf.abs().max())


def wrapped_decode_phase(params, cfg, lib, res, dev, steps: int = 2) -> dict:
    """Decode tokens past the wrap of Mixtral's ring (positions >= the
    window) for the prompts of 4104 (wrapped at prefill) and 4090 tokens,
    ``steps`` of each, held two ways, each within the 2^-5 max|logit| tie
    band:

    - the engine's token against the plain versions of the same
      computation: a plain prefill of the prompt into one slot's ring, then
      plain decodes teacher-forced with the engine's tokens;
    - the ring against no ring: the kernels' decode on one slot's ring
      (teacher-forced likewise) against a plain re-prefill of the grown
      sequence (prompt + the tokens before the step), which masks by window
      with no ring at all. Both with expert capacity for every token copy:
      a prefill drops the copies past an expert's capacity, last tokens
      first (``models.moe``), a decode never does, so at the configured
      capacity a re-prefill is not the function the decode computes.

    The re-prefill passes 4096 keys, so it takes ``attention_core``'s glue
    path (1024-key chunks, the last one shorter)."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import FusedInterpNumerics, PlainFusedNumerics

    w, m = cfg.sliding_window, cfg.moe
    no_drop = cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in res["lengths"]]
    streams = res["streams"]
    plain, kern = PlainFusedNumerics(lib), FusedInterpNumerics(lib)
    cache_len = res["cache_len"]

    checked = []
    with torch.inference_mode():
        for rid, p in enumerate(prompts):
            if len(p) + MAX_NEW - 1 <= w:
                continue
            first = max(1, w - len(p) + 1)  # decode step t runs at L + t - 1
            held = list(range(first, MAX_NEW))[:steps]
            toks = streams[rid]
            ring = {}  # (run, step) -> logits of one slot's ring decode
            for run, c, num in (("plain", cfg, plain),
                                ("kernels, no drop", no_drop, kern)):
                _, cache = tf.prefill(params, torch.as_tensor(
                    p, dtype=torch.int64, device=dev)[None], c, num,
                    cache_len)
                for t in range(1, held[-1] + 1):
                    lg, cache = tf.decode_step(
                        params, torch.tensor([[toks[t - 1]]], device=dev),
                        torch.tensor([len(p) + t - 1], device=dev), cache,
                        c, num)
                    ring[run, t] = lg[0, -1]
            for t in held:
                seq = np.concatenate([p, np.asarray(toks[:t], np.int32)])
                lp, _ = tf.prefill(params, torch.as_tensor(
                    seq, dtype=torch.int64, device=dev)[None], no_drop,
                    plain, cache_len)
                g1, b1 = _gap(ring["plain", t], toks[t])
                g2, b2 = _gap(lp[0, -1], int(ring["kernels, no drop",
                                                  t].argmax()))
                row = dict(rid=rid, step=t, position=len(seq) - 1,
                           ring_row=(len(seq) - 1) % w, engine_gap=g1,
                           engine_band=b1, ring_gap=g2, ring_band=b2)
                checked.append(row)
                if g1 > b1 or g2 > b2:
                    raise AssertionError(f"wrapped decode {row}")
    print(f"{cfg.name} wrapped decode: engine tokens vs the plain ring "
          f"decode, and the kernels' ring decode vs the plain re-prefill of "
          f"the grown sequence (capacity for every copy): "
          f"{sum(r['engine_gap'] == 0 for r in checked)} / "
          f"{sum(r['ring_gap'] == 0 for r in checked)} of {len(checked)} "
          f"equal, the rest in the tie band: {checked}")
    if len(checked) < 2 * steps:
        raise AssertionError("fewer wrapped decode steps than asked")
    return dict(checked=checked)


# a prime-length prompt past Mixtral's window beside MIXTRAL_LENGTHS' 4104
LONG_PREFILLS = (4099, 4104)


def long_prefill_phase(params, cfg, lib, cache_len: int, dev) -> dict:
    """One prefill into Mixtral's window ring on the kernels at each of
    ``LONG_PREFILLS``: past ``FUSED_ATTN_MAX_KEYS`` keys its attention runs
    ``attention_core``'s glue path, whose chunks are 1024 keys with a
    shorter last one, so a prime length costs what its neighbours do. Per
    length: ms per prefill on CUDA events (the eager glue's host gaps
    included) and the device ms of its kernels (torch.profiler), finite
    logits, and the greedy token against the plain versions' prefill of
    the same prompt within the 2^-5 max|logit| tie band."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import FusedInterpNumerics, PlainFusedNumerics

    rng = np.random.default_rng(2)
    kern, plain = FusedInterpNumerics(lib), PlainFusedNumerics(lib)
    rows = []
    with torch.inference_mode():
        for n in LONG_PREFILLS:
            ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                                  dtype=torch.int64, device=dev)[None]

            def run(num=kern):
                return tf.prefill(params, ids, cfg, num, cache_len)[0][0, -1]
            got, want = run().float(), run(plain).float()
            if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
                raise AssertionError(f"{n}-token prefill: non-finite logits")
            tok = int(got.argmax())
            gap = float(want.max() - want[tok])
            band = 2.0 ** -5 * float(want.abs().max())
            row = dict(tokens=n, ms=timed(run, iters=2, warmup=0),
                       device_ms=device_ms(run, iters=1,
                                           label=f"prefill {n}"),
                       token_gap=gap, band=band)
            print(f"{cfg.name} {n}-token prefill on the kernels: {row}")
            if gap > band:
                raise AssertionError(f"{n}-token prefill: greedy token out "
                                     f"of the tie band {row}")
            rows.append(row)
    return dict(rows=rows)


def _greedy(params, cfg, num, ids, cache_len, steps, forced=None, **kw):
    """Prefill ``ids`` (with ``kw``: ``frontend_emb`` or ``cross``, which
    every decode step takes too), then ``steps`` greedy decodes, or decodes
    teacher-forced with ``forced`` ((steps + 1, B) tokens). Returns the
    last-position logits of the prefill and of each step ((steps + 1, B,
    V)) and the greedy tokens ((steps + 1, B))."""
    import torch

    from repro_torch.models import transformer as tf

    b, s = ids.shape
    logits, cache = tf.prefill(params, ids, cfg, num, cache_len, **kw)
    step_kw = {k: v for k, v in kw.items() if k == "cross"}
    rows = [logits[:, -1]]
    toks = [rows[-1].argmax(-1)]
    for t in range(steps):
        tok = (toks[-1] if forced is None else forced[t])[:, None]
        pos = torch.full((b,), s + t, dtype=torch.int32, device=ids.device)
        logits, cache = tf.decode_step(params, tok, pos, cache, cfg, num,
                                       **step_kw)
        rows.append(logits[:, -1])
        toks.append(rows[-1].argmax(-1))
    return torch.stack(rows), torch.stack(toks)


def _hold_tokens(label, toks, plain_rows) -> dict:
    """Each greedy token of the kernels' run against the plain versions'
    logits at the same step (teacher-forced with those tokens): equal, or
    inside the 2^-5 max|logit| tie band."""
    ties, worst = 0, 0.0
    for t in range(toks.shape[0]):
        for i in range(toks.shape[1]):
            gap, band = _gap(plain_rows[t, i], int(toks[t, i]))
            worst = max(worst, gap / band)
            if gap > 0:
                ties += 1
                if gap > band:
                    raise AssertionError(
                        f"{label} step {t} row {i}: token {int(toks[t, i])} "
                        f"trails the plain argmax by {gap} > {band}")
    n = toks.numel()
    print(f"{label}: {n - ties} of {n} tokens equal to the plain versions' "
          f"argmax, {ties} inside the tie band (worst gap / band "
          f"{worst:.3f})")
    return dict(tokens=n, equal=n - ties, ties=ties, worst_gap_share=worst)


# InternVL2-2B's frontend run: one prompt of this many tokens, its first
# frontend_len (256) rows the projected patches
FRONTEND_PROMPT = 300


def frontend_phase(params, cfg, lib, dev) -> dict:
    """InternVL2-2B's model entry with its patches: one 300-token prompt
    whose first 256 rows are the projector's output for (1, 256, 1024)
    float32 patch embeddings from a seed, then ``MAX_NEW`` greedy decodes,
    through the kernels (the launch counts set to 0 just before and read
    just after: one prefill with one more ``act_lib`` for the projector's
    gelu, then the decodes), every token held against the plain versions
    teacher-forced with the kernels' tokens (``_hold_tokens``); the patches
    move the first token's logits; the prefill with patches and the
    projector alone timed."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import FusedInterpNumerics, PlainFusedNumerics

    kern, plain = FusedInterpNumerics(lib), PlainFusedNumerics(lib)
    g = torch.Generator(device=dev).manual_seed(26)
    emb = torch.randn(1, cfg.frontend_len, cfg.frontend_dim, device=dev,
                      generator=g)
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, FRONTEND_PROMPT), dtype=torch.int64,
        device=dev)[None]
    with torch.inference_mode():
        torch.cuda.synchronize()
        build.reset_launches()
        rows, toks = _greedy(params, cfg, kern, ids, CACHE_LEN, MAX_NEW,
                             frontend_emb=emb)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        pre, dec = per_forward(cfg, "prefill"), per_forward(cfg)
        want = {k: pre[k] + MAX_NEW * dec[k] + (k == "act_lib")
                for k in dec}
        print(f"{cfg.name} with {cfg.frontend_len} patches: launches "
              f"{launches}, expected {want}")
        if launches != want:
            raise AssertionError("frontend run: launch counts differ")
        plain_rows, _ = _greedy(params, cfg, plain, ids, CACHE_LEN, MAX_NEW,
                                forced=toks, frontend_emb=emb)
        held = _hold_tokens(f"{cfg.name} frontend run", toks, plain_rows)
        text, _ = tf.prefill(params, ids, cfg, kern, CACHE_LEN)
        moved = float((text[0, -1].float() - rows[0, 0].float()).abs().max())
        if not moved > 0:
            raise AssertionError("the patches did not move the logits")
        prefill_ms = timed(lambda: tf.prefill(params, ids, cfg, kern,
                                              CACHE_LEN, frontend_emb=emb),
                           iters=3, warmup=1)
        proj_ms = timed(lambda: tf._project_frontend(params, emb, cfg,
                                                     kern), iters=10)
    print(f"{cfg.name} prefill with patches {prefill_ms:.3f} ms, projector "
          f"{proj_ms:.3f} ms; patches move the first logits by {moved:.4f}")
    return dict(launches=launches, prompt=FRONTEND_PROMPT,
                patches=list(emb.shape), held=held, prefill_ms=prefill_ms,
                projector_ms=proj_ms, patch_logit_shift=moved,
                tokens=toks[:, 0].tolist())


# Whisper-tiny's run: 4 slots, 1500 frames, a 4-token prompt, the decoder's
# published 448-token text context as the cache, 64 greedy decode steps
WHISPER_CACHE, WHISPER_STEPS = 448, 64


def whisper_phase(lib, dev) -> dict:
    """Whisper-tiny at full width and depth (4 + 4 layers, bf16 weights
    from a seed) through its model entry, on the uniform library: the
    engine refuses an encoder-decoder (a request carries no frames), so
    the run is ``encoder_forward`` over (4, 1500, 384) float32 frames from
    a seed, ``prefill`` of a 4-token prompt with the encoder output as
    ``cross`` into a 448-row cache, and ``WHISPER_STEPS`` greedy
    ``decode_step``s with ``cross`` in an eager loop, the launch counts
    set to 0 just before and read just after (per forward: the encoder's
    4 attentions and 4 gelus, then 8 attentions (self and cross) and 4
    gelus per decoder forward; LayerNorm reads no table). Held against the
    plain versions: the encoder output within 2^-5 of its largest
    magnitude, every token teacher-forced (``_hold_tokens``). Timed: the
    encoder, the prefill and one decode step (eager on CUDA events, as one
    CUDA graph, and under the profiler: device ms, device ops, busy
    share) against the step's bound: the decoder's weights and the LM
    head, the cross rows and the live cache rows read once, the logits
    written once; its operations the per-step cross K / V re-projection
    (2 x 4 layers x 2 * 4 * 1500 * 384^2, which the reference recomputes
    every step too) and the decoder's products, at the bf16 rate."""
    import torch

    from repro_torch.configs import whisper_tiny
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import FusedInterpNumerics, PlainFusedNumerics

    cfg = whisper_tiny.CONFIG.replace(numerics="interp-fused")
    params = tf.init_params(cfg, seed=0, device=dev)
    leaves = list(_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{cfg.name} params: "
          f"{sum(t.numel() for t in leaves) / 1e6:.2f} M ({n_bytes / 1e9:.3f} "
          f"GB, {cfg.param_dtype}, the {cfg.max_pos}-row position table "
          f"included)")
    kern, plain = FusedInterpNumerics(lib), PlainFusedNumerics(lib)
    g = torch.Generator(device=dev).manual_seed(26)
    frames = torch.randn(SLOTS, cfg.encoder.source_len, cfg.d_model,
                         device=dev, generator=g)
    ids = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SLOTS, WHISPER_PROMPT)), dtype=torch.int64,
        device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        build.reset_launches()
        cross = tf.encoder_forward(params["encoder"], frames, cfg, kern)
        rows, toks = _greedy(params, cfg, kern, ids, WHISPER_CACHE,
                             WHISPER_STEPS, cross=cross)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        enc, pre, dec = (per_forward(cfg, m) for m in ("encoder", "prefill",
                                                       "decode"))
        want = {k: enc[k] + pre[k] + WHISPER_STEPS * dec[k] for k in dec}
        print(f"{cfg.name}: encoder + prefill + {WHISPER_STEPS} decodes, "
              f"launches {launches}, expected {want}")
        if launches != want:
            raise AssertionError("whisper run: launch counts differ")
        if not (torch.isfinite(cross).all() and rows.shape == (
                WHISPER_STEPS + 1, SLOTS, cfg.vocab_size)):
            raise AssertionError("whisper run: bad encoder output or logits")
        cross_p = tf.encoder_forward(params["encoder"], frames, cfg, plain)
        enc_err = float((cross.float() - cross_p.float()).abs().max())
        enc_band = 2.0 ** -5 * float(cross_p.float().abs().max())
        print(f"{cfg.name} encoder output {tuple(cross.shape)} against the "
              f"plain versions: max_abs_err {enc_err:.4f} (band "
              f"{enc_band:.4f} = 2^-5 max|x|)")
        if enc_err > enc_band:
            raise AssertionError("whisper encoder output differs from plain")
        plain_rows, _ = _greedy(params, cfg, plain, ids, WHISPER_CACHE,
                                WHISPER_STEPS, forced=toks, cross=cross_p)
        held = _hold_tokens(f"{cfg.name} run", toks, plain_rows)
        first_dlogit = float((rows[0].float() - plain_rows[0].float()
                              ).abs().max())

        encoder_ms = timed(lambda: tf.encoder_forward(
            params["encoder"], frames, cfg, kern), iters=5)
        prefill_ms = timed(lambda: tf.prefill(
            params, ids, cfg, kern, WHISPER_CACHE, cross=cross), iters=5)
        _, cache = tf.prefill(params, ids, cfg, kern, WHISPER_CACHE,
                              cross=cross)
        tok = toks[0][:, None]
        pos = torch.full((SLOTS,), WHISPER_PROMPT, dtype=torch.int32,
                         device=dev)

        def step():
            return tf.decode_step(params, tok, pos, cache, cfg, kern,
                                  cross=cross)
        step_ms = timed(step, iters=20)
        step_graph_ms, why = graph_ms(step)
        prof = profile_steps(step)
    # the step's bound: weights the decoder reads (not the encoder's, of the
    # embedding and position tables only the rows of this step's tokens)
    dec_bytes = n_bytes - sum(
        t.numel() * t.element_size()
        for t in (*_leaves(params["encoder"]), params["pos"],
                  params["embed"]["tok"]))
    es = 2
    d, v, n_l = cfg.d_model, cfg.vocab_size, cfg.n_layers
    src = cfg.encoder.source_len
    nbytes = (dec_bytes + 2 * SLOTS * d * es
              + SLOTS * src * d * es
              + n_l * 2 * SLOTS * cfg.n_kv_heads * (WHISPER_PROMPT + 1)
              * cfg.head_size * es + SLOTS * v * es)
    cross_flops = 2 * n_l * 2 * SLOTS * src * d * d
    dec_params = (dec_bytes - sum(t.numel() * t.element_size() for t in (
        params["final_norm"]["scale"], params["final_norm"]["bias"]))) / es
    flops = cross_flops + 2 * SLOTS * dec_params
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    busy = (None if prof.get("device_ms") is None
            else prof["device_ms"] / step_ms)
    print(f"{cfg.name} decode step (4 slots, 1500 frames): {step_ms:.3f} ms "
          f"eager, {_ms(step_graph_ms)} as one CUDA graph, device "
          f"{_ms(prof.get('device_ms'))} over {prof.get('device_ops')} "
          f"device ops, busy share {_share(busy)}; bound {b_ms:.4f} ms "
          f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of which "
          f"{cross_flops / 1e9:.2f} the cross K/V re-projection); encoder "
          f"{encoder_ms:.3f} ms, prefill {prefill_ms:.3f} ms")
    return dict(model=cfg.name, library="uniform",
                path=f"whisper {cfg.name} uniform", launches=launches,
                per_forward=dec, per_prefill=pre, per_encoder=enc,
                n_bytes=n_bytes, frames=list(frames.shape),
                prompt=WHISPER_PROMPT, cache_len=WHISPER_CACHE,
                steps=WHISPER_STEPS, encoder_max_abs_err=enc_err,
                encoder_band=enc_band, first_max_dlogit=first_dlogit,
                held=held, encoder_ms=encoder_ms, prefill_ms=prefill_ms,
                decode_step_ms=step_ms, decode_step_graph_ms=step_graph_ms,
                decode_step_graph_null=why, decode_profile=prof,
                busy_share=busy, step_bound_ms=b_ms, step_bound_by=b_by,
                step_bytes=nbytes, step_flops=flops,
                cross_kv_flops=cross_flops, tokens=toks.T.tolist())


def serve_phases(lib, seg_lib, dev) -> list[dict]:
    """Full-width Yi-6B (with the serial oracle, the fault, plan and AOT /
    async phases on its weights), DeepSeekMoE-16B at ``DEEPSEEK_LAYERS``
    layers on both libraries (with the AOT phase on the uniform one), then
    the other decoder families on
    the uniform library: MiniCPM3-4B (MLA; graph, eager and AOT engines),
    Mixtral-8x22B at ``MIXTRAL_LAYERS`` layers (graph and eager on its
    window ring, the wrapped decode against the plain re-prefill, a
    prime-length prefill), Qwen1.5-110B at ``QWEN_LAYERS`` layers and
    Minitron-8B (graph engines), then the SSM families: Mamba2-130M whole
    (graph and eager engines, the serial oracle) and Jamba-v0.1 at
    ``JAMBA_LAYERS`` layers (graph and eager), both on ``SSM_LENGTHS``;
    then InternVL2-2B whole (graph and eager engines: a text decoder, as
    the reference serves it; then its patches through the model entry,
    ``frontend_phase``) and Whisper-tiny whole through its model entry
    (``whisper_phase``: the engine refuses an encoder-decoder)."""
    from repro_torch.configs import (deepseek_moe_16b, internvl2_2b,
                                     jamba_v0_1_52b, mamba2_130m,
                                     minicpm3_4b, minitron_8b,
                                     mixtral_8x22b, qwen1_5_110b, yi_6b)

    serves = phase("serve yi_6b", serve_phase, [("uniform", lib)], dev,
                   yi_6b.CONFIG, extra=lambda params, cfg, r:
                   yi_extra_phases(params, cfg, lib, seg_lib, dev, r))
    freed(dev, "yi_6b")
    serves += phase("serve deepseek_moe_16b", serve_phase,
                    [("uniform", lib), ("segmented", seg_lib)], dev,
                    deepseek_moe_16b.CONFIG.replace(n_layers=DEEPSEEK_LAYERS),
                    extra=lambda params, cfg, _r: {"aot": phase(
                        "aot deepseek_moe_16b", aot_phase, params, cfg, lib,
                        dev)})
    freed(dev, "deepseek_moe_16b")
    serves += phase("serve minicpm3_4b", serve_phase, [("uniform", lib)],
                    dev, minicpm3_4b.CONFIG, extra=lambda params, cfg, _r: {
                        "aot": phase("aot minicpm3_4b", aot_phase, params,
                                     cfg, lib, dev)})
    freed(dev, "minicpm3_4b")
    mixtral = mixtral_8x22b.CONFIG
    serves += phase(
        "serve mixtral_8x22b", serve_phase, [("uniform", lib)], dev,
        mixtral.replace(n_layers=MIXTRAL_LAYERS),
        extra=lambda params, cfg, r: {
            "wrap": phase("mixtral wrapped decode", wrapped_decode_phase,
                          params, cfg, lib, r, dev),
            "long_prefill": phase("mixtral prime-length prefill",
                                  long_prefill_phase, params, cfg, lib,
                                  r["cache_len"], dev)},
        lengths=MIXTRAL_LENGTHS, cache_len=mixtral.sliding_window,
        tick_lengths=MIXTRAL_TICK)
    freed(dev, "mixtral_8x22b")
    serves += phase("serve qwen1_5_110b", serve_phase, [("uniform", lib)],
                    dev, qwen1_5_110b.CONFIG.replace(n_layers=QWEN_LAYERS),
                    modes=("graph",))
    freed(dev, "qwen1_5_110b")
    serves += phase("serve minitron_8b", serve_phase, [("uniform", lib)],
                    dev, minitron_8b.CONFIG, modes=("graph",))
    freed(dev, "minitron_8b")
    serves += phase("serve mamba2_130m", serve_phase, [("uniform", lib)],
                    dev, mamba2_130m.CONFIG, extra=lambda params, cfg, _r: {
                        "serial_oracle": phase(
                            "serial oracle mamba2_130m", serial_oracle_phase,
                            params, cfg, dev, lengths=SSM_LENGTHS)},
                    lengths=SSM_LENGTHS, tick_lengths=SSM_TICK)
    freed(dev, "mamba2_130m")
    serves += phase("serve jamba_v0_1_52b", serve_phase, [("uniform", lib)],
                    dev, jamba_v0_1_52b.CONFIG.replace(n_layers=JAMBA_LAYERS),
                    lengths=SSM_LENGTHS, tick_lengths=SSM_TICK)
    freed(dev, "jamba_v0_1_52b")
    serves += phase("serve internvl2_2b", serve_phase, [("uniform", lib)],
                    dev, internvl2_2b.CONFIG, extra=lambda params, cfg, _r: {
                        "frontend": phase("frontend internvl2_2b",
                                          frontend_phase, params, cfg, lib,
                                          dev)})
    freed(dev, "internvl2_2b")
    serves.append(phase("whisper_tiny", whisper_phase, lib, dev))
    return serves


# the train runs: Yi-6B at full width, cut to TRAIN_LAYERS of its 32
# layers (~1.90 B parameters, ~30 GB of train state), a global batch of
# TRAIN_BATCH sequences of TRAIN_SEQ tokens in TRAIN_MICRO microbatches;
# Mamba2-130M whole through the Trainer, with a checkpoint every 2 steps
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 8, 2048, 4, 2
TRAIN_EXACT_STEPS, TRAIN_INTERP_STEPS = 6, 3
MAMBA_TRAIN = dict(seq_len=512, global_batch=8, steps=6, every=2, cut=4)


def _timed_steps(step, state, data, steps: int, first: int = 0):
    """``steps`` train steps from ``first`` on CUDA events; returns (state,
    [metrics as floats], [ms per step])."""
    import torch

    hist, ms = [], []
    for i in range(first, first + steps):
        batch = data.batch_at(i)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state, m = step(state, batch, i)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist, ms


def _train_figures(label, cfg, n_params, hist, ms, smi) -> dict:
    """ms per step (the median past the first step, which warms up),
    tokens/s and the model-FLOPs share 6 N tokens / (s x 989 TFLOP/s)."""
    warm = sorted(ms[1:]) or ms
    step_ms = warm[len(warm) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"ms_per_step": step_ms, "ms": ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "mfu": 6 * n_params * tokens / (step_ms / 1e3 * BF16_FLOPS),
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist]}
    print(f"train {label} [{smi}]: {step_ms:.1f} ms/step (CUDA events, "
          f"median of steps 1..{len(ms) - 1}), {out['tokens_per_s']:.0f} "
          f"tokens/s, model-FLOPs share {out['mfu']:.3f} (6 N tokens over "
          f"989 TFLOP/s, N = {n_params / 1e9:.3f} B); losses "
          f"{[round(x, 4) for x in out['losses']]}")
    return out


def train_phase(lib, dev) -> dict:
    """The train path (``repro_torch.train``) on the card.

    (a) Yi-6B at full width (d 4096, 32 / 4 heads, d_ff 11008, vocab
    64000), cut to ``TRAIN_LAYERS`` layers, bf16 random weights from a
    seed, ``remat="block"``, sequences of ``TRAIN_SEQ`` tokens, a global
    batch of ``TRAIN_BATCH`` in ``TRAIN_MICRO`` microbatches, through
    ``make_train_step`` (the Trainer would checkpoint the ~30 GB state at
    step 0): ``TRAIN_EXACT_STEPS`` steps under exact numerics (losses
    finite, the last at least 0.2 below the first; ms per step on CUDA
    events, tokens/s, ``max_memory_allocated``, the model-FLOPs share, the busy
    share of one more step under torch.profiler), then from the same
    initial state ``TRAIN_INTERP_STEPS`` steps under interp numerics bound
    to ``lib`` (the unfused glue: every table read one ``library_eval``
    launch), the launch counts set to 0 just before and read just after.
    Held: the interp step-0 loss within the reference's 0.15 * max(1,
    |exact|) of the exact one, and bitwise equal to the same loss with
    the plain evaluator (``library_eval_ref`` in the same glue) on the
    same card, its grad_norm within 1e-5 relative (autograd's index
    backward accumulates in no fixed order).

    (b) Mamba2-130M whole through ``Trainer`` (exact numerics): 6 steps of
    8 x 512 tokens with a checkpoint every 2 steps into a temporary
    directory, against a run cut after step 3 and resumed from its step-2
    checkpoint by a new Trainer: the final losses within rtol 1e-5."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data import dataset_for
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import count_params
    from repro_torch.kernels import build
    from repro_torch.numerics.ops import InterpNumerics, PlainFusedNumerics
    from repro_torch.optim import global_norm
    from repro_torch.train import (StepConfig, Trainer, TrainerConfig,
                                   make_train_step, train_state_init)
    from repro_torch.train.step import batch_to, loss_and_grads

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {"card": smi}
    cfg = get_config("yi_6b").replace(n_layers=TRAIN_LAYERS, remat="block")
    n_params = count_params(tf.param_shapes(cfg))
    # with a warmup of 2, a peak of 1e-4 spikes the loss at step 4 on the
    # card; torch.optim.AdamW on the same gradients and float32 weights
    # spike alike, and a warmup of 20 does not (tools/train_lr_probe.py,
    # PERF.md): the run takes 2e-5
    sc = StepConfig(microbatches=TRAIN_MICRO, peak_lr=2e-5, warmup=2,
                    total_steps=TRAIN_EXACT_STEPS)
    data = dataset_for(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)

    torch.cuda.reset_peak_memory_stats(dev)
    state = train_state_init(cfg, sc, seed=0, device=dev)
    step = make_train_step(cfg, sc, donate=True)
    state, hist, ms = _timed_steps(step, state, data, TRAIN_EXACT_STEPS)
    exact = _train_figures("yi_6b exact", cfg, n_params, hist, ms, smi)
    exact["max_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    nxt = [TRAIN_EXACT_STEPS]

    def one_more():
        nonlocal state
        state, _ = step(state, data.batch_at(nxt[0]), nxt[0])
        nxt[0] += 1

    exact["profile"] = profile_steps(one_more, n=1)
    losses = exact["losses"]
    # the step must move the model: 11.454 -> 10.620 on an H100 (700 W)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] - 0.2:
        raise AssertionError(f"exact train losses {losses}")
    print(f"train yi_6b exact [{smi}]: max_memory_allocated "
          f"{exact['max_memory_gb']:.2f} GB; busy share "
          f"{exact['profile'].get('device_busy_share')}")
    out["yi_6b_exact"] = exact
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # interp numerics bound to the uniform library, from the same state
    icfg = cfg.replace(numerics="interp")

    class PlainInterpNumerics(InterpNumerics):
        """The unfused glue around the plain evaluator
        (``library_eval_ref``) on any device."""

        _eval = PlainFusedNumerics._eval

    state = train_state_init(icfg, sc, seed=0, device=dev)
    b0 = batch_to(data.batch_at(0), dev)
    p_loss, _, p_grads = loss_and_grads(state.params, b0, icfg,
                                        PlainInterpNumerics(lib), TRAIN_MICRO)
    p_loss, p_gnorm = float(p_loss), float(global_norm(p_grads))
    del p_grads
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step = make_train_step(icfg, sc, lib, donate=True)
    build.reset_launches()
    state, hist, ms = _timed_steps(step, state, data, TRAIN_INTERP_STEPS)
    launches = dict(build.LAUNCHES)
    interp = _train_figures("yi_6b interp", icfg, n_params, hist, ms, smi)
    interp["max_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    interp["launches"] = launches
    interp["library_eval_per_step"] = (launches["library_eval"]
                                       / TRAIN_INTERP_STEPS)
    others = {k: v for k, v in launches.items() if v and k != "library_eval"}
    if not launches["library_eval"] or others:
        raise AssertionError(f"interp train launches {launches}")
    il, el = interp["losses"][0], exact["losses"][0]
    interp.update(exact_step0=el, plain_loss=p_loss, plain_grad_norm=p_gnorm,
                  grad_norm_rel=abs(interp["grad_norms"][0] - p_gnorm)
                  / p_gnorm)
    print(f"train yi_6b interp [{smi}]: {interp['library_eval_per_step']:.0f}"
          f" library_eval launches per step; step-0 loss {il!r} (plain "
          f"evaluator {p_loss!r}, exact {el!r}); grad_norm "
          f"{interp['grad_norms'][0]!r} (plain {p_gnorm!r}, rel "
          f"{interp['grad_norm_rel']:.2e}); max_memory_allocated "
          f"{interp['max_memory_gb']:.2f} GB")
    if not all(np.isfinite(interp["losses"])):
        raise AssertionError(f"interp train losses {interp['losses']}")
    if abs(il - el) > 0.15 * max(1.0, abs(el)):
        raise AssertionError(f"interp step-0 loss {il} vs exact {el}")
    if il != p_loss or interp["grad_norm_rel"] > 1e-5:
        raise AssertionError(f"kernel vs plain evaluator: loss {il!r} vs "
                             f"{p_loss!r}, grad_norm rel "
                             f"{interp['grad_norm_rel']}")
    out["yi_6b_interp"] = interp
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # Mamba2-130M whole through the Trainer: straight against cut + resume
    mcfg = get_config("mamba2_130m")
    mt = MAMBA_TRAIN
    with tempfile.TemporaryDirectory() as tmp:
        def tc(sub, steps):
            return TrainerConfig(
                steps=steps, ckpt_dir=f"{tmp}/{sub}", ckpt_every=mt["every"],
                log_every=100, seq_len=mt["seq_len"],
                global_batch=mt["global_batch"],
                step=StepConfig(total_steps=mt["steps"], warmup=2,
                                peak_lr=1e-3))

        t0 = time.perf_counter()
        straight = Trainer(mcfg, tc("a", mt["steps"]), device=dev).run()
        straight_s = time.perf_counter() - t0
        Trainer(mcfg, tc("b", mt["cut"]), device=dev).run()
        t3 = Trainer(mcfg, tc("b", mt["steps"]), device=dev)
        if t3.start_step != mt["cut"] - 1:
            raise AssertionError(f"resumed at {t3.start_step}")
        resumed = t3.run()
    a, b = straight[-1]["loss"], resumed[-1]["loss"]
    rel = abs(a - b) / abs(a)
    mamba = {"losses": [h["loss"] for h in straight],
             "resumed_losses": [h["loss"] for h in resumed],
             "wall_s": [h["wall_s"] for h in straight],
             "straight_s": straight_s, "resume_rel": rel,
             "n_params": count_params(tf.param_shapes(mcfg))}
    print(f"train mamba2_130m [{smi}]: straight {straight_s:.1f} s for "
          f"{mt['steps']} steps with {len(range(0, mt['steps'], mt['every']))}"
          f" checkpoints; final loss {a!r}, resumed from step "
          f"{mt['cut'] - 2} {b!r} (rel {rel:.2e})")
    if not all(np.isfinite(mamba["losses"])) or rel > 1e-5:
        raise AssertionError(f"mamba2 resume: {a!r} vs {b!r}")
    out["mamba2_130m"] = mamba
    gc.collect()
    torch.cuda.empty_cache()
    return out


def freed(dev, name: str) -> None:
    """Free what the last serve run left (its weights and cache go before
    the next init) and print what stays allocated."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"after freeing {name}: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")


def path_launches(serves) -> dict:
    """Kernel launches of each serve run's graph engine (the main path; the
    kernels line's ``launches`` is their sum) and of the plan, AOT and mesh
    paths' own runs, one entry per run (each engine's
    ``stats["launches"]``, read just after its run: a graph replay adds
    its capture's launches), and the mesh phase's fleet split (the
    wrappers' counts around its three calls)."""
    out: dict = {}
    for sv in serves:
        out[sv.get("path", f"serve {sv['model']} {sv['library']}")] = \
            sv["launches"]
        extra = sv.get("extra") or {}
        runs = {"plan three_slot": extra.get("plans", {}).get("three_slot"),
                "frontend": extra.get("frontend")}
        mesh = extra.get("mesh", {})
        runs.update({f"mesh {k}": mesh.get(k) for k in ("unmeshed",
                                                        "meshed")})
        if mesh:
            out[f"mesh fleet split {sv['model']}"] = mesh["fleet_launches"]
        runs.update({f"aot {k}": extra.get("aot", {}).get(k)
                     for k in ("graph", "aot")})
        for path, run in runs.items():
            if run:
                out[f"{path} {sv['model']}"] = run["launches"]
    return out


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
    dse = phase("dse", dse_phase, dev)
    m = lib.meta("silu")

    def silu_codes(gate):
        xc = torch.clamp(gate.float(), m.act_lo, m.act_hi - 1e-6)
        return _quantize((xc - m.act_lo) / (m.act_hi - m.act_lo), m.in_bits)

    ie_row, ie_details = phase("interp_eval", interp_eval_phase, designs,
                               dev, silu_codes)

    walk_rows, walk_details = phase("walk", walk_phase, seg_lib, seg_designs,
                                    lib, designs, dev, silu_codes)
    rows, details = phase("kernels", kernel_phases, lib, dev, silu_codes)
    family_rows = phase("family kernel shapes", family_kernel_phase, lib,
                        dev)
    _, seg_details = phase("kernels", kernel_phases, seg_lib, dev,
                           silu_codes, "segmented")
    act_rows, act_details, act_launches = phase(
        "act_lib", act_phase, [("uniform", lib), ("segmented", seg_lib)], dev)
    new_acts = phase("new activations", new_act_phase,
                     [("uniform", lib), ("segmented", seg_lib)], dev)
    tab_rows, pertable = phase("per-table", pertable_phase, lib, dev)
    serves = serve_phases(lib, seg_lib, dev)
    train = phase("train", train_phase, lib, dev)
    train_launches = train["yi_6b_interp"]["launches"]
    launches = {name: sum(sv["launches"][name] for sv in serves)
                + train_launches[name] for name in build.LAUNCHES}
    by_path = path_launches(serves)
    by_path["train yi_6b interp"] = train_launches
    # every launch of the DSE phase: its studies' envelope kernels and
    # probe engines, and the plan CLI
    by_path["dse"] = dse.pop("launches")
    launches.update(gen["launches"])
    launches["rom_eval"] = seg_gen["launches"]["rom_eval"]
    for name in ENVELOPE_KERNELS:
        launches[name] += seg_gen["launches"][name]
    launches.update(pertable["launches"])
    # the eager chain (the interp backend's activation, act_phase) has its
    # own entry; ``launches`` keeps the main path's counts
    by_path["eager chain"] = act_launches
    idle = [name for name, n in launches.items()
            if not n and name not in OFF_MAIN_PATH]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle} ({launches})")
    for name in OFF_MAIN_PATH:
        if not act_launches[name]:
            raise AssertionError(f"{name} never launched on the eager chain")

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
    family = {}  # the new families' shapes of each serving kernel
    for r in family_rows:
        family.setdefault(r["name"], []).append(
            {k: r.get(k) for k in ("shape", "mode", "dv", "window",
                                   "max_abs_err", "graph_ms", "bound_ms",
                                   "bound_by", "library_graph_ms")})
    for name, (source, rep) in replaces.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": rep,
                        "launches": launches[name],
                        **({"off_main_path": OFF_MAIN_PATH[name]}
                           if name in OFF_MAIN_PATH else {}),
                        "launches_by_path": {
                            path: n[name] for path, n in by_path.items()
                            if n.get(name)},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "graph_ms": r["graph_ms"],
                        "library_graph_ms": r["library_graph_ms"],
                        "family_shapes": family.get(name, [])})
    report = {"device": smi[0], "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build.BUILD_LOG["seconds"],
              "kernel_phases": (dspace_details + ie_details + walk_details
                                + details + seg_details + act_details
                                + family_rows),
              "new_activations": new_acts,
              "generator": gen, "pertable": pertable, "serve": serves,
              "train": train, "dse": dse,
              "launches_by_path": by_path,
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
