#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on one H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the seed the run draws the weights on the card (``weights.py``) and
the requests (``traffic.py``); it loads the vendored 12-bit R6 tables as
the ROM, builds ``repro_torch``'s ``ServeEngine`` with the cell's options
(CUDA graphs on), warms up the shapes the cell uses, lets the load loop
(``loop.py``) reach a steady state and measures for ``--seconds``. Then it
reads the peak memory, frees the engine and holds a sample of the served
requests against the float32 reference (``reference/``), and prints one
JSON line: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a profiled stretch of the window,
``trace.py``). Every metric is a reader in ``metrics/<name>.py``.

It exits non-zero and prints no result where there is no CUDA card, or
fewer than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or
the JAX package (``repro``) is loaded once the window has closed. Build
and kernel caches stay inside the checkout (``build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _process_age() -> float:
    """Seconds since this process started (``/proc``), at ``T_START``."""
    try:
        fields = open("/proc/self/stat").read().rsplit(")", 1)[1].split()
        uptime = float(open("/proc/uptime").read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = _process_age()


def setup_clock() -> float:
    return AGE_AT_START + time.perf_counter() - T_START


def prepare_env() -> None:
    """Caches at fixed paths inside the checkout; the program's package on
    the path; no JAX through ``transformers``."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def reference_imports_program() -> list[str]:
    """Modules under ``reference/`` that import the program or JAX."""
    bad = []
    for path in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".", 1)[0] in (*FORBIDDEN, "repro_torch")
                   for n in names):
                bad.append(path.name)
    return bad


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def as_run(cfg: dict) -> dict:
    """The configuration file's published keys with its ``as_run`` values
    over them: what the program runs where it departs from the source and
    has no option to follow it, and so what the reference computes."""
    return {**cfg, **cfg.get("as_run", {})}


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(the cell's ``BENCHMARK.json`` entry, its workload file, its
    configuration as run, :func:`as_run`)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return (entry, load_json(HERE / "workloads" / f"{name}.json"),
            as_run(load_json(ROOT / conf["file"])))


def metric_names(name: str, trace: bool) -> list[str]:
    """The metrics this cell reports: end-to-end with ``trace`` off,
    per-layer with it on (a metric without ``workloads`` in every cell
    that reports what it moves)."""
    bench = load_json(ROOT / "BENCHMARK.json")

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m["name"] for m in bench["end_to_end"] if here(m)]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if here(m) and m["moves"] in e2e]


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the program ------------------------------------------------------------
# the configuration file's keys -> the port's ModelConfig fields
_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
         "num_attention_heads": "n_heads",
         "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
         "vocab_size": "vocab_size", "rope_theta": "rope_theta",
         "tie_word_embeddings": "tie_embeddings", "torch_dtype": "param_dtype",
         "hidden_act": "act"}
_MOE_KEYS = {"n_routed_experts": "n_experts", "num_experts_per_tok": "top_k",
             "moe_intermediate_size": "d_expert",
             "n_shared_experts": "n_shared",
             "moe_capacity_factor": "capacity_factor"}


def program_config(cfg: dict, pcfg=None):
    """The port's config of the file's ``program_config``, under the file's
    numerics and RoPE base, held to every size the file states."""
    from repro_torch.configs.base import get_config

    pcfg = (pcfg or get_config(cfg["program_config"])).replace(
        numerics=cfg["numerics"], rope_theta=cfg["rope_theta"])
    want = {v: cfg[k] for k, v in _KEYS.items()}
    have = {v: getattr(pcfg, v) for v in want}
    moe = pcfg.moe is not None
    want["d_ff" if not moe else "first_dense_ff"] = cfg["intermediate_size"]
    have["d_ff" if not moe else "first_dense_ff"] = (
        pcfg.d_ff if not moe else pcfg.first_dense_ff)
    if moe:
        for k, v in _MOE_KEYS.items():
            want["moe." + v], have["moe." + v] = cfg[k], getattr(pcfg.moe, v)
        want["dense layers"] = cfg["first_k_dense_replace"]
        have["dense layers"] = int(pcfg.first_dense_ff is not None)
    if want != have or moe != ("n_routed_experts" in cfg):
        diff = {k: (have.get(k), v) for k, v in want.items()
                if have.get(k) != v}
        raise SystemExit(f"{cfg['name']}: the program's config differs from "
                         f"the file (program, file): {diff}")
    return pcfg


def cap_len(engine_opts: dict, prompt: int) -> int:
    """The prefill length an admission runs at: the smallest of the cell's
    buckets (those within the cache) that holds the prompt, else the
    prompt's own length."""
    fit = [b for b in engine_opts.get("aot_buckets") or ()
           if prompt <= b <= engine_opts["cache_len"]]
    return min(fit) if fit else prompt


def build(cell: dict, cfg: dict, seed: int, device, pcfg=None):
    """(tree of weights, engine) for a cell."""
    import torch

    from repro_torch.api.library import InterpLibrary
    from repro_torch.serve.engine import ServeEngine

    from portbench import weights

    pcfg = program_config(cfg, pcfg)
    tree = weights.make(cfg, seed, device)
    lib = InterpLibrary.default_library(device)
    e = cell["engine"]
    eng = ServeEngine(pcfg, tree, slots=e["slots"], cache_len=e["cache_len"],
                      library=lib, horizon=e["horizon"], max_queue=None,
                      aot_buckets=tuple(e["aot_buckets"]) or None,
                      max_pack=e["max_pack"],
                      graph=torch.device(device).type == "cuda",
                      device=device)
    return tree, eng


def warm(eng, cell: dict, vocab: int) -> None:
    """Run one short request at each of the cell's exact-length prefill
    lengths, so that no first use of a shape falls in the window."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(0)
    for i, n in enumerate(cell["engine"]["warm_prompts"]):
        eng.submit(Request(-1 - i, rng.integers(0, vocab, n, dtype=np.int32),
                           2))
    eng.run()


def serve(eng, cell: dict, cfg: dict, seed: int, seconds: float,
          trace: bool = False, on_open=None) -> dict:
    """Warm the loop up, measure for ``seconds``; the run's records."""
    import torch

    from repro_torch.serve.engine import Rejected, Request

    from portbench import loop as loop_mod, traffic, trace as tr

    t = cell["traffic"]
    reqs = traffic.requests(t, cfg["vocab_size"], seed)
    lp = loop_mod.Loop(eng, Request, reqs, t, cell["engine"]["horizon"],
                       rejected=Rejected)
    keys = ("ticks", "decode_steps", "prefills", "admit_replays",
            "aot_hits", "aot_misses", "aot_fallbacks", "captures")
    prof, state = None, {}
    if trace:
        prof = tr.profiler(lambda p: state.setdefault("trace", tr.read(p)))
        lp.span = torch.profiler.record_function
        prof.start()  # the profiler's own set-up, before the window
    lp.start()
    if t["loop"] == "closed":
        lp.run_steps(t["warmup_steps"])
        opened = lp.clock()
    else:
        opened = lp.run_until(lp.t0 + t["warmup_s"])
    if on_open is not None:
        on_open()
    at_open = {k: eng.stats[k] for k in keys}
    hook = None
    if trace:  # the window's last trace_seconds; read once it has closed
        start_at = opened + seconds - cell["trace_seconds"]

        def hook(now):
            if "on" not in state and now >= start_at:
                prof.step()  # recording starts
                state["on"] = lp.clock()
    closed = lp.run_until(opened + seconds, hook)
    if prof is not None:
        prof.step()  # recording stops; the trace is read
        prof.stop()
    at_close = {k: eng.stats[k] for k in keys}
    run = {"cfg": cfg, "cell": cell, "records": lp.records,
           "steps": lp.steps, "window": (opened, closed),
           "stats": (at_open, at_close), "late": lp.late}
    if "trace" in state:
        run["trace"] = state["trace"]
    return run


def drain(eng) -> None:
    """Finish what the engine holds: the queue dropped, each live request
    cut to the tokens it has (it retires at the next tick). The tools that
    serve several seeds or rates from one engine call it between them."""
    eng.queue.clear()
    for r in eng.req:
        if r is not None:
            r.max_new = len(r.out)
    eng.run()


def sample(run: dict, seed: int) -> list[dict]:
    """Finished requests of the window drawn from the seed, the longest
    among them: what the reference checks."""
    import numpy as np

    from portbench import stats

    done = [r for r in run["records"]
            if r["error"] is None and r["done"] is not None
            and stats.inside(r["done"], run["window"])]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["prompt"]) + r["seen"])
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    k = min(run["cell"]["check"]["sample"] - 1, len(rest))
    picked = [longest] + [rest[i] for i in rng.choice(len(rest), k,
                                                      replace=False)]
    e = run["cell"]["engine"]
    return [{"rid": r["rid"], "prompt": r["prompt"],
             "out": list(r["request"].out), "max_new": r["max_new"],
             "cap_len": cap_len(e, len(r["prompt"]))} for r in picked]


def verdict(found: dict, limits: dict, short: list) -> dict:
    """``found`` (a gap summary of :mod:`portbench.reference.compare`)
    judged: every number ``limits`` names at or under its limit, some rows
    compared and no stream in ``short``."""
    out = dict(found, limits=limits, short_or_bad=short)
    out["correct"] = bool(found.get("rows")) and not short and all(
        found[k] <= v for k, v in limits.items())
    return out


def judge(tree: dict, cfg: dict, cell: dict, picked: list[dict], device,
          control: bool = False) -> dict:
    """The reference's verdict on the sampled requests (:func:`verdict`
    under the cell's ``check.limits``: ``max_gap``, ``mean_gap``), a
    stream short or out of the vocabulary failing it. With ``control`` the
    tokens the fp8 control puts first at the same rows are judged the same
    way, under ``"control"``."""
    from portbench.reference import compare

    limits = cell["check"]["limits"]
    short = [r["rid"] for r in picked if len(r["out"]) < r["max_new"]
             or not all(0 <= t < cfg["vocab_size"] for t in r["out"])]
    found = (compare.check(tree, cfg, picked, device=device, control=control)
             if picked else {"rows": 0})
    low = found.pop("control", None)
    out = verdict(found, limits, short)
    if control:
        out["control"] = verdict(low or {"rows": 0}, limits, [])
    return out


def run_cell(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
             device, names: list[str], pcfg=None) -> dict:
    """One run of a cell: the result line's dict, and the lines for
    standard error (``notes``)."""
    import torch

    from portbench import stats

    notes = []
    tree, eng = build(cell, cfg, seed, device, pcfg)
    warm(eng, cell, cfg["vocab_size"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    marks = {}

    def on_open():
        marks["setup_s"] = setup_clock()
        if cuda:  # the set-up's own peak, then the window's apart
            marks["setup_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    run = serve(eng, cell, cfg, seed, seconds, trace, on_open=on_open)
    run["setup_s"] = marks["setup_s"]
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(marks.get("setup_peak", 0), window_peak)
    lo, hi = run["window"]
    due = [r for r in run["records"] if stats.inside(r["due"], run["window"])]
    late = sorted(run["late"])
    notes.append(f"setup_s {run['setup_s']}")
    notes.append(f"memory peak {peak} bytes: set-up "
                 f"{marks.get('setup_peak', 0)}, window {window_peak}")
    notes.append(
        f"loop: window {hi - lo:.3f} s, {len(run['steps'])} steps, "
        f"submitted late by p50 {stats.percentile(late, 50) * 1e3:.3f} ms "
        f"p99 {stats.percentile(late, 99) * 1e3:.3f} ms max "
        f"{late[-1] * 1e3:.3f} ms over {len(late)} requests")
    s0, s1 = run["stats"]
    notes.append("engine over the window: " + json.dumps(
        {k: s1[k] - s0[k] for k in s0}) + f"; graph {eng.stats['graph']}, "
        f"captures {eng.stats['captures']} in "
        f"{eng.stats['capture_s']:.3f} s")
    metrics = {}
    for m in names:
        v = reader(m)(run)
        if v is not None:
            metrics[m] = v
    result = {"metrics": metrics, "peak": peak,
              "attempted": len(due),
              "failed": sum(r["error"] is not None for r in due)}
    if "trace" in run:
        from portbench import trace as tr

        t = run["trace"]
        result["busy_s"] = tr.busy_s(t)
        result["window_s"] = t["stretch"][1] - t["stretch"][0]
        result["breakdown"] = tr.breakdown(t)
        notes.append(f"trace: {len(t['device'])} device events, "
                     f"{len(t['launches'])} graph launches, "
                     f"{len(tr.step_spans(t))} steps in "
                     f"{result['window_s']:.3f} s")
    picked = sample(run, seed)
    del eng, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v = judge(tree, cfg, cell, picked, device)
    notes.append(f"check: {len(picked)} requests, {v['rows']} served "
                 f"tokens, reference {time.perf_counter() - t0:.3f} s, "
                 f"max gap {v.get('max_gap')}, mean gap "
                 f"{v.get('mean_gap')}, other-token share "
                 f"{v.get('other_token_share')}")
    result["verdict"] = v
    result["notes"] = notes
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    bad = reference_imports_program()
    if bad:
        print(f"portbench: reference modules import the program: {bad}",
              file=sys.stderr)
        return 3
    entry, cell, cfg = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < entry["chips"]):
        print(f"portbench: needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, cfg, args.seed, args.seconds, bool(args.trace),
                   "cuda",
                   metric_names(args.workload, bool(args.trace)))
    found = loaded_forbidden()
    if found:
        print(f"portbench: loaded after the window: {found}", file=sys.stderr)
        return 3
    v = res["verdict"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"], "memory_peak_bytes": res["peak"]}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    bench = load_json(ROOT / "BENCHMARK.json")
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    line = {"correct": v["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": {m: {"value": x, "unit": units[m]}
                        for m, x in res["metrics"].items()},
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["check"] = {k: {"value": v.get(k), "limit": lim}
                     for k, lim in v["limits"].items()}
    line["check"]["short_or_bad_requests"] = {"value": len(v["short_or_bad"]),
                                              "limit": 0}
    for n in res["notes"]:
        print(n, file=sys.stderr)
    print("check: " + "; ".join(f"{k} {c['value']} limit {c['limit']}"
                                for k, c in line["check"].items()),
          file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
