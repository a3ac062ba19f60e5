"""Shared pieces of the harness's CPU tests: the program's smoke configs
as configuration files, and a tiny cell of each loop."""
from __future__ import annotations

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def smoke(arch: str):
    """(configuration dict, the program's config) at smoke size."""
    from repro_torch.configs.base import get_smoke_config

    p = get_smoke_config(arch)
    c = {"name": arch, "program_config": arch, "hidden_act": p.act,
         "hidden_size": p.d_model, "num_attention_heads": p.n_heads,
         "num_key_value_heads": p.n_kv_heads,
         "num_hidden_layers": p.n_layers, "vocab_size": p.vocab_size,
         "rms_norm_eps": 1e-6, "rope_theta": p.rope_theta,
         "tie_word_embeddings": p.tie_embeddings,
         "torch_dtype": p.param_dtype, "head_dim": p.head_size,
         "numerics": "interp-fused"}
    if p.moe is None:
        c["intermediate_size"] = p.d_ff
    else:
        c.update(intermediate_size=p.first_dense_ff,
                 moe_intermediate_size=p.moe.d_expert,
                 n_routed_experts=p.moe.n_experts,
                 n_shared_experts=p.moe.n_shared,
                 num_experts_per_tok=p.moe.top_k, first_k_dense_replace=1,
                 norm_topk_prob=True,
                 moe_capacity_factor=p.moe.capacity_factor)
    return c, p


def cell_limits(arch: str) -> dict:
    """The correctness limits of the configuration's decode cell."""
    cell = json.loads((ROOT / "portbench" / "workloads" /
                       f"{arch}.decode.json").read_text())
    return cell["check"]["limits"]


def tiny_cell(loop: str, limits: dict) -> dict:
    """A cell of each loop at smoke size, its outputs as long as its
    prompts or longer, as in the decode cells (prompts of median 384,
    outputs 256-768), so that the decode through the cache carries a
    request's rows. Prompts past the largest bucket are admitted at their
    own length. The check takes every request the window finished (the
    sample is larger than the window's count), so a fault in some of the
    slots cannot miss it."""
    t = {"prompt": {"dist": "uniform", "min": 8, "max": 24},
         "output": {"dist": "uniform", "min": 16, "max": 36}, "block": 8,
         "requests": 256}
    if loop == "closed":
        t.update(loop="closed", clients=4, stagger=True, warmup_steps=4)
    else:
        t.update(loop="open", arrivals="poisson", rate=20.0, warmup_s=0.3)
    return {"engine": {"slots": 4, "cache_len": 64, "horizon": 4,
                       "aot_buckets": [8, 16], "max_pack": 2,
                       "warm_prompts": [17, 24]},
            "traffic": t, "check": {"sample": 64, "limits": limits},
            "trace_seconds": 0.3}


@pytest.fixture
def run_tiny():
    """``run_tiny(arch, loop)``: one harness run on the CPU at smoke size
    (no look for a card) under the limits of the configuration's own
    cell, its result dict."""
    import torch

    from portbench import run as R

    # the loop's window is wall time: with test workers side by side, a
    # few threads each keep every run's steps coming
    torch.set_num_threads(min(torch.get_num_threads(), 2))

    def go(arch: str, loop: str = "closed", seconds: float = 3.0,
           seed: int = 2_147_483_659):
        c, p = smoke(arch)
        return R.run_cell(tiny_cell(loop, cell_limits(arch)), c, seed,
                          seconds, False, "cpu",
                          ["output_tokens_per_s", "itl_p95_ms", "setup_s"],
                          pcfg=p)
    return go
