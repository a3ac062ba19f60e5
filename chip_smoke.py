#!/usr/bin/env python3
"""Card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a). It

1. prints the card's name and power limit and the torch / CUDA versions,
   and builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (raising on a mismatch beyond the stated tolerance)
   and times kernel, plain version and a yardstick PyTorch call with CUDA
   events;
3. serves 6 requests on full-width Yi-6B (bf16, random weights from a
   seeded generator, the default interpolation library) through the
   continuous-batching engine with interp-fused numerics, asserts every
   request completes with in-vocabulary tokens and finite logits, that each
   kernel launched exactly its expected count per forward pass, and that
   each request's first token matches a plain-version prefill on the card
   (tie-aware);
4. prints the throughput, a ``{"kernels": [...]}`` JSON line and, last,
   ``{"ok": true, "device": {...}}``.

Any failure raises (non-zero exit) before the last line. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM data-sheet peaks (dense): HBM bandwidth, bf16 tensor-core and
# float32 CUDA-core rates. Integer glue is counted at the float32 rate.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SERVE_LENGTHS = (17, 64, 200, 511, 33, 128)
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


def device_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds of the CUDA kernels one ``fn()`` launches,
    from torch.profiler (CUPTI): the kernels' own execution time, without
    the host's launch gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_dev_us(e) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / iters / 1e3


def _dev_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else getattr(e, "self_cuda_time_total", 0))


def bound(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phases(lib, dev, silu_codes):
    """Each kernel against its plain version, timed; returns rows for the
    kernels line and details."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flashattn.ops import attention_fused_library
    from repro_torch.kernels.flashattn.ref import attention_fused_library_ref
    from repro_torch.kernels.interp.ops import library_eval
    from repro_torch.kernels.interp.ref import library_eval_ref
    from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library
    from repro_torch.kernels.rmsnorm.ref import approx_rmsnorm_library_ref
    from repro_torch.numerics.ops import softmax_ulp_bound

    g = torch.Generator(device=dev).manual_seed(1234)
    rows, details = {}, []

    # -- library_eval: the SwiGLU silu codes -------------------------------
    silu = lib.func_id("silu")
    meta = lib.meta_rows()
    for shape in ((4, 1, 11008), (1, 512, 11008)):
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
                                                     meta)),
                   call_ms=timed(lambda: library_eval(codes, silu, lib.coeffs,
                                                      meta)),
                   plain_ms=device_ms(lambda: library_eval_ref(
                       codes, fids, lib.coeffs, meta), iters=3),
                   library_ms=device_ms(lambda: F.silu(gate)),
                   bound_ms=b_ms, bound_by=b_by)
        details.append(row)
        rows.setdefault("library_eval", row)

    # -- rmsnorm_lib -------------------------------------------------------
    rs_tol = 2 * 2.0 ** -(lib.meta("rsqrt").out_bits - 1) + 2.0 ** -7
    for n_rows in (4, 512):
        x = (torch.randn(n_rows, 4096, device=dev, generator=g) * 2
             ).to(torch.bfloat16)
        gamma = torch.rand(4096, device=dev, generator=g) + 0.5
        got = approx_rmsnorm_library(x, gamma, lib).float()
        want = approx_rmsnorm_library_ref(x, gamma, lib).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        print(f"rmsnorm_lib ({n_rows}, 4096) bf16: max_abs_err {err:.3e}, "
              f"max rel {rel:.3e} (tolerance rel {rs_tol:.3e}: 2 rsqrt-table "
              f"ulps + 1 bf16 rounding)")
        if rel > rs_tol:
            raise AssertionError(f"rmsnorm_lib ({n_rows}, 4096) differs")
        b_ms, b_by = bound(2 * x.numel() * 2 + 4096 * 4, 4 * x.numel(),
                           F32_FLOPS)
        g16 = gamma.to(torch.bfloat16)
        row = dict(name="rmsnorm_lib", shape=[n_rows, 4096], max_abs_err=err,
                   tolerance=rs_tol,
                   ms=device_ms(lambda: approx_rmsnorm_library(x, gamma, lib)),
                   call_ms=timed(lambda: approx_rmsnorm_library(x, gamma,
                                                                lib)),
                   plain_ms=device_ms(lambda: approx_rmsnorm_library_ref(
                       x, gamma, lib), iters=3),
                   library_ms=device_ms(lambda: F.rms_norm(x, (4096,), g16,
                                                           1e-6)),
                   bound_ms=b_ms, bound_by=b_by)
        details.append(row)
        rows.setdefault("rmsnorm_lib", row)

    # -- flash_attn_lib ----------------------------------------------------
    sm_bound = softmax_ulp_bound(lib.meta("exp2neg"), lib.meta("recip"))
    bf = dict(device=dev, dtype=torch.bfloat16)
    h, kvh, d = 32, 4, 128
    for mode in ("decode", "prefill"):
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
        print(f"flash_attn_lib {mode} B={b} H={h} KVH={kvh} D={d} Sq={sq} "
              f"Sk={sk}: max_abs_err {err:.3e} (tolerance {tol_abs:.3e} = "
              f"({n_tiles} tiles + 2) x softmax_ulp_bound {sm_bound:.3e} x "
              f"max|v|, + 2^-7 (max|v| + |out|) bf16 roundings)")
        if excess > 0:
            raise AssertionError(f"flash_attn_lib {mode} differs from plain")
        twin = attention_fused_library_ref(q, k, v, lib, block_k=64, **kw
                                           ).float()
        terr = (got - twin).abs()
        t_excess = float((terr - sm_bound * vmax - 2.0 ** -8 * twin.abs()
                          ).max())
        print(f"  against the tile-by-tile twin (64-key tiles): max_abs_err "
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
        nbytes = (q.numel() * 2 + 2 * live_rows * kvh * d * 2
                  + kv_pos.numel() * 4 + q_pos.numel() * 4 + q.numel() * 2)
        b_ms, b_by = bound(nbytes, 4 * d * h * pairs, BF16_FLOPS)
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
                   mode=mode, max_abs_err=err, tolerance=tol_abs,
                   ms=device_ms(lambda: attention_fused_library(q, k, v, lib,
                                                                **kw)),
                   call_ms=timed(lambda: attention_fused_library(q, k, v,
                                                                 lib, **kw)),
                   plain_ms=device_ms(lambda: attention_fused_library_ref(
                       q, k, v, lib, **kw), iters=3),
                   library_ms=device_ms(sdpa), bound_ms=b_ms, bound_by=b_by)
        details.append(row)
        rows.setdefault("flash_attn_lib", row)
    for r in details:
        print(f"  device time {r['name']} {r['shape']}: kernel {r['ms']:.5f} "
              f"ms, plain {r['plain_ms']:.5f} ms, library "
              f"{r['library_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}); back-to-back call {r['call_ms']:.5f} ms")
    return rows, details


def serve_phase(lib, dev):
    """Full-width Yi-6B through the engine; returns results for the report."""
    import numpy as np
    import torch

    from repro_torch.configs.yi_6b import CONFIG
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import PlainFusedNumerics
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = CONFIG.replace(numerics="interp-fused")
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"yi_6b params: {n_params / 1e9:.3f} B ({cfg.param_dtype}), "
          f"random init {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(cfg, params, slots=SLOTS, cache_len=CACHE_LEN,
                      library=lib, horizon=HORIZON, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_LENGTHS]
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new=MAX_NEW))

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    if sorted(r.rid for r in done) != list(range(len(prompts))):
        raise AssertionError(f"not every request completed: {done}")
    for r in done:
        if len(r.out) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                            for t in r.out):
            raise AssertionError(f"request {r.rid}: bad stream {r.out}")
    forwards = eng.stats["prefills"] + eng.stats["decode_steps"]
    per_forward = {"library_eval": cfg.n_layers,
                   "rmsnorm_lib": 2 * cfg.n_layers + 1,
                   "flash_attn_lib": cfg.n_layers}
    expected = {k: n * forwards for k, n in per_forward.items()}
    print(f"main path: {eng.stats['prefills']} prefills + "
          f"{eng.stats['decode_steps']} decode steps = {forwards} forwards; "
          f"launches {launches}, expected {expected}")
    if launches != expected or eng.stats["launches"] != expected:
        raise AssertionError("kernel launch counts differ from the path")
    n_tok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.2f} tokens/s (end to end, prefills included)")

    # decode step time at 4 live slots on the filled cache
    num = eng.numerics
    tok = torch.zeros((SLOTS, 1), dtype=torch.int64, device=dev)
    pos = torch.tensor([300, 400, 500, 600], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        step_ms = timed(lambda: tf.decode_step(params, tok, pos, eng.caches,
                                               cfg, num), iters=10)
    print(f"decode step (4 slots, positions 300-600, cache {CACHE_LEN}): "
          f"{step_ms:.3f} ms; weight-streaming bound "
          f"{2 * n_params / HBM_BPS * 1e3:.3f} ms")
    with torch.inference_mode():
        prof = profile_steps(lambda: tf.decode_step(params, tok, pos,
                                                    eng.caches, cfg, num))
        long_prompt = torch.as_tensor(prompts[SERVE_LENGTHS.index(511)],
                                      dtype=torch.int64, device=dev)[None]
        print("prefill of the 511-token prompt:")
        prof_pre = profile_steps(lambda: tf.prefill(params, long_prompt, cfg,
                                                    num, CACHE_LEN), n=1)

    # first tokens against a plain-version prefill on the card
    plain = PlainFusedNumerics(lib)
    max_dlogit = 0.0
    ties = 0
    with torch.inference_mode():
        for r, p in zip(sorted(done, key=lambda r: r.rid), prompts):
            t = torch.as_tensor(p, dtype=torch.int64, device=dev)[None]
            lp, _ = tf.prefill(params, t, cfg, plain, CACHE_LEN)
            lk, _ = tf.prefill(params, t, cfg, num, CACHE_LEN)
            lp, lk = lp[0, -1].float(), lk[0, -1].float()
            if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
                raise AssertionError(f"request {r.rid}: non-finite logits")
            if int(lk.argmax()) != r.out[0]:
                raise AssertionError(f"request {r.rid}: engine first token "
                                     f"{r.out[0]} != its own prefill")
            d = float((lk - lp).abs().max())
            max_dlogit = max(max_dlogit, d)
            tol = 2.0 ** -5 * float(lp.abs().max())
            gap = float(lp.max() - lp[r.out[0]])
            if gap > 0:
                ties += 1
                if gap > tol:
                    raise AssertionError(
                        f"request {r.rid}: first token {r.out[0]} trails the "
                        f"plain prefill's argmax by {gap} > {tol}")
    print(f"first tokens vs plain prefill: {len(done) - ties} equal, {ties} "
          f"inside the tie band (2^-5 max|logit|); max |dlogit| "
          f"{max_dlogit:.4f}")
    return dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                decode_step_ms=step_ms, decode_profile=prof,
                prefill_profile=prof_pre,
                launches=launches, forwards=forwards,
                stats=eng.stats, n_params=n_params, max_dlogit=max_dlogit,
                first_token_ties=ties,
                streams={r.rid: r.out for r in done})


KERNEL_SYMBOLS = {"library_eval": "library_eval_kernel",
                  "rmsnorm_lib": "rmsnorm_lib_kernel",
                  "flash_attn_lib": "flash_attn_lib_kernel"}


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
    kernels = {}
    for name, sym in KERNEL_SYMBOLS.items():
        hit = [r for r in rows if sym in r[0]]
        n_launch = sum(r[2] for r in hit)
        kernels[name] = (sum(r[1] for r in hit) / n_launch / 1e3
                         if n_launch else None)
    if not rows:
        print("profiler: no device time recorded (not measured)")
        return {"device_busy_share": None}
    print(f"profiler, {n} calls: device busy {busy / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall = {busy / wall_us:.3f} busy share")
    for name, ms in kernels.items():
        print(f"  {name}: device {ms:.5f} ms per launch" if ms is not None
              else f"  {name}: no launches in the trace")
    for key, dev_us, count in rows[:10]:
        print(f"  top device op: {dev_us / n / 1e3:.4f} ms/step "
              f"x{count // n} {key[:90]}")
    return {"device_busy_share": busy / wall_us, "wall_ms": wall_us / 1e3 / n,
            "device_ms": busy / 1e3 / n, "kernel_device_ms": kernels,
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
    from repro_torch.api.library import InterpLibrary
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

    lib = InterpLibrary.default_library(dev)
    print(f"library {lib.rom_sha()} {tuple(lib.coeffs.shape)}")
    m = lib.meta("silu")

    def silu_codes(gate):
        xc = torch.clamp(gate.float(), m.act_lo, m.act_hi - 1e-6)
        return _quantize((xc - m.act_lo) / (m.act_hi - m.act_lo), m.in_bits)

    rows, details = kernel_phases(lib, dev, silu_codes)
    serve = serve_phase(lib, dev)

    kernels = []
    replaces = {
        "library_eval": ("src/repro_torch/csrc/interp.cu",
                         "src/repro/kernels/interp/kernel.py:241"),
        "rmsnorm_lib": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm/kernel.py:62"),
        "flash_attn_lib": ("src/repro_torch/csrc/flashattn.cu",
                           "src/repro/kernels/flashattn/kernel.py:220"),
    }
    for name, (source, rep) in replaces.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": rep,
                        "launches": serve["launches"][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    report = {"device": smi[0], "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build.BUILD_LOG["seconds"],
              "kernel_phases": details, "serve": serve}
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
