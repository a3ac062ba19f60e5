"""Plain float32 reference of the served decoders (dense GQA and
DeepSeekMoE-style MoE), written from the published architectures.

It imports nothing of the program. It reads the benchmark's own weight
tree (the layout of ``portbench.weights``) and the configuration file's
published keys, and computes every matrix product in float32 with TF32 off
(the caller sets the backend flags, :func:`no_tf32`). Transcendentals are
the exact functions (``torch.exp``, ``torch.rsqrt``, ``F.silu``): the
program's 12-bit tables approximate these within their certificate, so the
reference is the mathematics the served numerics stand for.

What the serving path does to a request, and this reference redoes:

* the prompt's rows are one causal pass (RoPE positions 0..P-1), each
  served token one more row at the next position, attending to every
  earlier row;
* an MoE layer routes each row to its ``top_k`` experts by a float32
  softmax over the router's logits, taken in descending order with ties to
  the lower expert id, and renormalises the chosen gates where
  ``norm_topk_prob`` says so. With a ``moe_capacity_factor`` ``cf`` the
  prompt's rows are dispatched as one example whose per-expert capacity is
  ``max(min(int(n * k * cf / E), n * k), 4)`` with ``n`` the prefill
  length the admission ran at (the prompt, or the bucket it was padded to;
  pad rows come after the prompt and take no earlier place), and copies
  past the capacity are dropped; a served row is its own example of one
  row, whose k distinct experts always fit. Without one no copy is
  dropped.

The configuration it reads is the one the program runs (the file's
``as_run`` values over its published keys), so that where the program
departs from the source, the reference computes the same departure.

The model is run layer by layer over every sequence of a sample, so only
one layer's weights are upcast to float32 at a time. ``quant="fp8"`` is
the control of the correctness check: every matrix product's weight cast
to float8 e4m3 with a float32 scale per output column (the router, the
embedding rows and the norm scales stay as they are), the step below the
bf16 weights the configuration serves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0


def no_tf32() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., in, out) through float8 e4m3 with one scale per output
    column, back in float32."""
    w = w.to(F32)
    scale = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).to(F32) * scale


def layer_list(cfg: dict) -> list[tuple[str, int | None, str]]:
    """Per layer: (segment, index in its stack or None, ffn kind)."""
    n = cfg["num_hidden_layers"]
    if "n_routed_experts" not in cfg:
        return [("seg0", i, "mlp") for i in range(n)]
    k = cfg["first_k_dense_replace"]
    out = [("seg0", None if k == 1 else i, "mlp") for i in range(k)]
    return out + [("seg1", i, "moe") for i in range(n - k)]


def _layer(tree: dict, seg: str, i: int | None, quant: str | None,
           device) -> dict:
    """One layer's weights in float32 on ``device`` (matrix products'
    weights through :func:`fp8_columns` under ``quant="fp8"``)."""
    out = {}
    for group, leaves in tree["segments"][seg]["0"].items():
        out[group] = {}
        for name, t in leaves.items():
            t = (t if i is None else t[i]).to(device=device, dtype=F32)
            if quant == "fp8" and t.dim() >= 2 and name != "router":
                t = fp8_columns(t)
            out[group][name] = t
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (L, H, D) at positions 0..L-1: the halves rotated by theta^(-2i/D)."""
    n, _, d = x.shape
    inv = torch.exp(-torch.arange(0, d, 2, dtype=F32, device=x.device) / d
                    * math.log(theta))
    ang = torch.arange(n, dtype=F32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def attention(p: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Causal GQA over the whole sequence, one query group at a time."""
    n = x.shape[0]
    h, kvh, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    g = h // kvh
    theta = cfg["rope_theta"]
    q = rope((x @ p["wq"]).reshape(n, h, d), theta)
    k = rope((x @ p["wk"]).reshape(n, kvh, d), theta)
    v = (x @ p["wv"]).reshape(n, kvh, d)
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(n, h, d, dtype=F32, device=x.device)
    for j in range(kvh):
        qj = q[:, j * g:(j + 1) * g].transpose(0, 1)  # (g, n, d)
        s = (qj @ k[:, j].T) / math.sqrt(d)
        s = torch.where(mask, s, -math.inf)
        out[:, j * g:(j + 1) * g] = (torch.softmax(s, -1)
                                     @ v[:, j]).transpose(0, 1)
    return out.reshape(n, h * d) @ p["wo"]


def swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    gate, up = torch.chunk(x @ wi, 2, dim=-1)
    return (F.silu(gate) * up) @ wo


def capacity(n: int, cfg: dict) -> int:
    """The per-expert capacity of an example of ``n`` rows (every copy
    without a ``moe_capacity_factor``)."""
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    if cfg.get("moe_capacity_factor") is None:
        return n * k
    c = int(n * k * cfg["moe_capacity_factor"] / e)
    return max(min(c, n * k), 4)


def route(x: torch.Tensor, router: torch.Tensor, cfg: dict):
    """Expert ids (L, k), in descending probability with ties to the lower
    id, and their gates (renormalised where ``norm_topk_prob``)."""
    probs = torch.softmax(x @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg["num_experts_per_tok"]
    gate = vals[:, :k]
    if cfg["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return idx[:, :k], gate


def moe(p: dict, x: torch.Tensor, cfg: dict, prompt: int,
        cap_len: int, routes: list | None = None) -> torch.Tensor:
    """The MoE FFN over one sequence: rows [0, prompt) one example of
    capacity ``capacity(cap_len)``, every later row its own example. The
    expert ids (rows, k) are appended to ``routes`` where one is given."""
    n = x.shape[0]
    e_n, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    idx, gate = route(x, p["router"], cfg)
    if routes is not None:
        routes.append(idx.cpu())
    flat = idx.reshape(-1)  # token-major copies
    onehot = F.one_hot(flat, e_n)
    onehot[prompt * k:] = 0  # served rows take no place in the prompt's
    place = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    row = torch.arange(n * k, device=x.device) // k
    keep = (row >= prompt) | (place < capacity(cap_len, cfg))
    weight = (gate.reshape(-1) * keep).reshape(n, k)
    y = torch.zeros_like(x)
    for e in range(e_n):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            out = swiglu(x[rows], p["wi"][e], p["wo"][e])
            y.index_add_(0, rows, out * weight[rows, slot][:, None])
    if cfg.get("n_shared_experts"):
        y = y + swiglu(x, p["shared_wi"], p["shared_wo"])
    return y


def logits(tree: dict, cfg: dict, seqs: list[dict], quant: str | None = None,
           device=None, routes: list | None = None) -> list[torch.Tensor]:
    """float32 logits of each sequence at every row from its prompt's last
    on: ``seqs`` holds dicts with ``ids`` (the prompt and then every served
    token but the last, int64), ``prompt`` (its length) and ``cap_len``
    (the admission's prefill length). Row r of the result predicts token
    ``prompt + r`` of the stream, that is served token r. With ``routes``
    (a list), each sequence's expert ids of every MoE layer, in layer
    order, are appended to it as one list per sequence."""
    device = device if device is not None else tree["final_norm"][
        "scale"].device
    eps = cfg["rms_norm_eps"]
    tok = tree["embed"]["tok"]
    hs = [tok[s["ids"].to(tok.device)].to(device=device, dtype=F32)
          for s in seqs]
    per_seq = [[] for _ in seqs]
    if routes is not None:
        routes.extend(per_seq)
    for seg, i, ffn in layer_list(cfg):
        p = _layer(tree, seg, i, quant, device)
        for j, s in enumerate(seqs):
            h = hs[j]
            h = h + attention(p["mixer"], rmsnorm(h, p["norm1"]["scale"], eps),
                              cfg)
            x = rmsnorm(h, p["norm2"]["scale"], eps)
            f = p["ffn"]
            h = h + (moe(f, x, cfg, s["prompt"], s["cap_len"],
                         per_seq[j] if routes is not None else None)
                     if ffn == "moe" else swiglu(x, f["wi"], f["wo"]))
            hs[j] = h
        del p
    head = tree["embed"]["head"].to(device=device, dtype=F32)
    if quant == "fp8":
        head = fp8_columns(head)
    scale = tree["final_norm"]["scale"].to(device=device, dtype=F32)
    return [rmsnorm(h[s["prompt"] - 1:], scale, eps) @ head
            for h, s in zip(hs, seqs)]
