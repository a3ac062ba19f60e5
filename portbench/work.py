"""Operations and bytes the served model needs, from the configuration
file's sizes alone, and the data-sheet peaks they are held against.

The conventions are the port's (``repro_torch.launch.xprof``): a matrix
product is 2 x M x N x K; attention is 2 x (D + Dv) per live query-key
pair and query head (the causal triangle of a prefill, every earlier key
of a decode row); elementwise work is not counted. Model FLOPs count what
a token needs: the matrix parameters it passes through (for an MoE layer
the router, its ``top_k`` experts and the shared experts), the LM head
only for rows whose logits are taken (a prefill's last row, every decode
row), attention over the live keys. Bytes count every input read once and
every output written once: for ``flash_attn_lib``, q and its output, and
the live K/V rows with their positions. This file imports nothing of the program.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)
BF16 = 2


def layer_count(cfg: dict) -> int:
    return cfg["num_hidden_layers"]


def attn_params(cfg: dict) -> int:
    d, h, kvh, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], cfg["head_dim"])
    return d * h * hd * 2 + d * kvh * hd * 2


def ffn_params(cfg: dict) -> list[int]:
    """Active matrix parameters of each layer's FFN, per token."""
    d = cfg["hidden_size"]
    dense = 3 * d * cfg["intermediate_size"]
    if "n_routed_experts" not in cfg:
        return [dense] * layer_count(cfg)
    de = cfg["moe_intermediate_size"]
    moe = (d * cfg["n_routed_experts"]
           + 3 * d * de * (cfg["num_experts_per_tok"]
                           + cfg["n_shared_experts"]))
    k = cfg["first_k_dense_replace"]
    return [dense] * k + [moe] * (layer_count(cfg) - k)


def body_params(cfg: dict) -> int:
    """Matrix parameters a token passes through below the LM head."""
    return attn_params(cfg) * layer_count(cfg) + sum(ffn_params(cfg))


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def attn_pair_flops(cfg: dict) -> int:
    """FLOPs of one query-key pair over every query head of one layer."""
    return 2 * 2 * cfg["head_dim"] * cfg["num_attention_heads"]


def prefill_flops(cfg: dict, n: int) -> float:
    """Model FLOPs of an ``n``-token prompt: every row through the body,
    the head on the last row, the causal triangle in every layer."""
    return (2.0 * body_params(cfg) * n + 2.0 * head_params(cfg)
            + attn_pair_flops(cfg) * layer_count(cfg) * n * (n + 1) / 2)


def decode_flops(cfg: dict, pos: int) -> float:
    """Model FLOPs of one decode row at position ``pos`` (``pos + 1``
    keys)."""
    return (2.0 * (body_params(cfg) + head_params(cfg))
            + attn_pair_flops(cfg) * layer_count(cfg) * (pos + 1))


def flash_launch(cfg: dict, rows: list[tuple[int, int]],
                 elem: int = BF16) -> tuple[float, float]:
    """FLOPs and bytes of one ``flash_attn_lib`` launch of one layer over
    ``rows``: (query rows, keys before the first query row) per sequence,
    each query row attending causally (row j of a sequence sees
    ``start + j + 1`` keys). Reads q, the live K/V rows and their int32
    positions once, writes the output once (``elem`` bytes an element)."""
    h, kvh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    flops = byts = 0.0
    for q, start in rows:
        pairs = q * start + q * (q + 1) / 2
        flops += 2 * 2 * hd * h * pairs
        byts += (elem * ((start + q) * kvh * 2 * hd + q * h * 2 * hd)
                 + 4 * (start + 2 * q))
    return flops, byts


def bound_s(flops: float, byts: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, byts / PEAK_BYTES)
