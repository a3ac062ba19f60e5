"""Roofline analysis (twin of ``repro/launch/roofline.py``): three terms
per (arch x shape x mesh) cell from the dry run's per-rank profiles.

    compute    = FLOPs_per_rank / peak_FLOP/s
    memory     = HBM_bytes_per_rank / HBM_bw
    collective = collective_bytes_per_rank / link_bw

All three are seconds per step on one card's resources; the bottleneck is
the largest. MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE); the ratio
MODEL_FLOPS / traced FLOPs measures how much of the traced compute is
useful. The profiles are already per rank (``launch.xprof``: one rank's
op stream, the layer loop scaled by its repeats).

The constants are the H100 SXM5 datasheet's (``launch.mesh``): 989 TFLOP/s
dense bf16, 3.35 TB/s HBM3, and for the collective term the per-card
network port (``NET_BW``, one 400 Gb/s NDR link: 50 GB/s), since every
16-way axis of the production mesh spans more than one 8-card NVLink
node. These are analytic bounds from datasheet figures, not measurements.

Only the port's own records are read (``"package": "repro_torch"``, as
``launch.dryrun`` stamps them): a reference record in the directory is
skipped and counted on stderr.

Usage: python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch] [--md]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch.dryrun import DEFAULT_OUT as DEFAULT_DIR
from repro_torch.launch.dryrun import PACKAGE
from repro_torch.launch.mesh import HBM_BW, NET_BW, PEAK_FLOPS_BF16


# ---------------------------------------------------------------------------
# analytic parameter counts / useful-FLOPs model
# ---------------------------------------------------------------------------

def param_counts(cfg) -> tuple[int, int]:
    """(total params, active-per-token params) from the config alone."""
    from repro_torch.models.layers import count_params
    from repro_torch.models.transformer import model_shapes
    total = count_params(model_shapes(cfg))
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        # routed expert params counted per layer: only top_k of n_experts
        per_expert = 3 * cfg.d_model * m.d_expert  # SwiGLU wi(2f) + wo(f)
        n_moe_layers = _n_moe_layers(cfg)
        active = total - n_moe_layers * (m.n_experts - m.top_k) * per_expert
    return total, active


def _n_moe_layers(cfg) -> int:
    from repro_torch.models.transformer import layer_plan
    n = 0
    for seg in layer_plan(cfg):
        n += sum(k.ffn == "moe" for k in seg.pattern) * seg.repeat
    return n


def model_flops(cfg, shape, kind: str) -> float:
    """Useful FLOPs per step: 6 N_active D for training, 2 N_active per
    decoded token for decode, 2 N_active D for prefill."""
    _, active = param_counts(cfg)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch  # decode: one token per row


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def cell_roofline(rec: dict) -> dict | None:
    if rec.get("status") != "ok" or "profile" not in rec:
        return None
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    chips = 512 if rec["mesh"] == "pod2x16x16" else 256
    prof = rec["profile"]
    t_c = prof["flops"] / PEAK_FLOPS_BF16
    t_m = prof["hbm_bytes"] / HBM_BW
    t_l = prof["total_collective_bytes"] / NET_BW
    useful = model_flops(cfg, shape, shape.kind)
    useful_per_chip = useful / chips
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    dom = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_l)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", ""),
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_l,
        "dominant": dom,
        "model_flops": useful, "traced_flops_per_chip": prof["flops"],
        "useful_ratio": (useful_per_chip / prof["flops"] if prof["flops"]
                         else 0.0),
        # fraction of roofline: useful work at peak over the bound term
        "roofline_frac": ((useful_per_chip / PEAK_FLOPS_BF16) / bound
                          if bound else 0.0),
        "temp_bytes": rec["memory"]["temp_bytes"],
    }


def load_records(d: pathlib.Path, tag: str = "") -> list[dict]:
    """The port's dry-run records of ``tag`` in ``d``; records another
    package wrote (no ``"package": "repro_torch"``) are skipped, and their
    count printed on stderr."""
    out, other = [], 0
    for f in sorted(d.glob("*.json")):
        if f.name.endswith(".ops.json"):
            continue
        rec = json.loads(f.read_text())
        if rec.get("package") != PACKAGE:
            other += 1
        elif rec.get("tag", "") == tag:
            out.append(rec)
    if other:
        print(f"roofline: skipped {other} record(s) in {d} not written by "
              f"{PACKAGE}", file=sys.stderr)
    return out


def fmt_s(x: float) -> str:
    return f"{x*1e3:8.2f}ms" if x >= 1e-4 else f"{x*1e6:8.1f}us"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(DEFAULT_DIR))
    ap.add_argument("--tag", default="")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    rows = []
    for rec in load_records(pathlib.Path(args.dir), args.tag):
        r = cell_roofline(rec)
        if r is None:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "status": rec["status"],
                         "reason": rec.get("reason",
                                           rec.get("error", ""))[:60]})
        else:
            r["status"] = "ok"
            rows.append(r)
    if args.md:
        print("| arch | shape | mesh | compute | memory | collective | bound |"
              " useful/traced | roofline |")
        print("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if r["status"] != "ok":
                print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - |"
                      f" - | {r['status']}: {r['reason']} | - | - |")
            else:
                print(f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
                      f" {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} |"
                      f" {fmt_s(r['collective_s'])} | {r['dominant']} |"
                      f" {r['useful_ratio']:.2f} | {r['roofline_frac']:.3f} |")
    else:
        for r in rows:
            if r["status"] != "ok":
                print(f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:10s} "
                      f"{r['status']}: {r['reason']}")
            else:
                print(f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:10s} "
                      f"C {fmt_s(r['compute_s'])}  M {fmt_s(r['memory_s'])}  "
                      f"L {fmt_s(r['collective_s'])}  -> {r['dominant']:10s} "
                      f"useful {r['useful_ratio']:.2f}  "
                      f"roofline {r['roofline_frac']:.3f}")


if __name__ == "__main__":
    main()
