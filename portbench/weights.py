"""The benchmark's weights: drawn on the device from ``--seed`` in the
served dtype, one ``randn`` per leaf, in the program's parameter tree.

The tree is the layout ``repro_torch`` serves from: ``embed/{tok,head}``,
``segments/seg<i>/0/{norm1,mixer,norm2,ffn}`` (each leaf stacked over a
leading layer axis where a segment has more than one layer),
``final_norm``. A dense model is one segment; DeepSeekMoE's dense layer 0
is ``seg0`` (unstacked) and its MoE layers ``seg1``. Matrices are (in,
out) and drawn with std 1/sqrt(in); embedding rows with std 1; norm scales
are 1 + 0.1 N(0, 1), so the check sees the scale; the router is float32,
as the program keeps it. The same tensors go to the program and to the
reference.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_shapes(cfg: dict) -> dict:
    """path -> (shape, dtype name) in draw order."""
    d, dt = cfg["hidden_size"], cfg["torch_dtype"]
    h, kvh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    out = {"embed/tok": ((cfg["vocab_size"], d), dt),
           "embed/head": ((d, cfg["vocab_size"]), dt)}

    def layer(seg: str, n: int, ffn: dict) -> None:
        lead = (n,) if n > 1 else ()
        base = f"segments/{seg}/0/"
        parts = {"norm1/scale": (d,), "mixer/wq": (d, h * hd),
                 "mixer/wk": (d, kvh * hd), "mixer/wv": (d, kvh * hd),
                 "mixer/wo": (h * hd, d), "norm2/scale": (d,), **ffn}
        for name, shape in parts.items():
            out[base + name] = (lead + shape,
                                "float32" if name.endswith("router") else dt)

    n = cfg["num_hidden_layers"]
    ff = cfg["intermediate_size"]
    dense = {"ffn/wi": (d, 2 * ff), "ffn/wo": (ff, d)}
    if "n_routed_experts" not in cfg:
        layer("seg0", n, dense)
    else:
        k = cfg["first_k_dense_replace"]
        e, de = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        ns = cfg["n_shared_experts"] * de
        layer("seg0", k, dense)
        layer("seg1", n - k, {
            "ffn/router": (d, e), "ffn/wi": (e, d, 2 * de),
            "ffn/wo": (e, de, d), "ffn/shared_wi": (d, 2 * ns),
            "ffn/shared_wo": (ns, d)})
    out["final_norm/scale"] = ((d,), dt)
    return out


def _std(path: str, shape: tuple) -> float:
    if path == "embed/tok":
        return 1.0
    return 1.0 / math.sqrt(shape[-2])


def fill(tree: dict, cfg: dict, seed: int) -> dict:
    """Draw every leaf of ``tree`` again from ``seed``, in place (the
    tensors keep their addresses, so a captured graph still reads them)."""
    dev = tree["final_norm"]["scale"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    for path, (shape, _) in leaf_shapes(cfg).items():
        t = get(tree, path)
        t.normal_(0.0, 1.0, generator=gen)
        if path.endswith("scale"):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(_std(path, shape))
    return tree


def make(cfg: dict, seed: int, device) -> dict:
    """A new tree on ``device`` drawn from ``seed``."""
    tree: dict = {}
    for path, (shape, dt) in leaf_shapes(cfg).items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = torch.empty(shape, dtype=DTYPES[dt], device=device)
    return fill(tree, cfg, seed)


def get(tree: dict, path: str) -> torch.Tensor:
    for key in path.split("/"):
        tree = tree[key]
    return tree
