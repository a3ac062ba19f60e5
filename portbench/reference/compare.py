"""The comparison that decides ``correct``: served greedy tokens held
against the reference's logits.

For every served token the gap is the reference's best logit at that row
minus the reference's logit of the token served there. A greedy program
that computes the reference's function up to rounding serves the best
token or one whose logit is within rounding of it; a program that is
wrong somewhere serves tokens far below the best. The summary holds the
widest gap over the sample (``max_gap``), the mean gap (``mean_gap``) and
the share of rows where another token was served; a cell's
``check.limits`` names the ones compared.
"""
from __future__ import annotations

import torch

from portbench.reference import model


def gaps(ref_logits: list[torch.Tensor], served: list[list[int]]) -> torch.Tensor:
    """All rows' gaps, one sequence after the other (float32, host)."""
    out = []
    for lg, toks in zip(ref_logits, served):
        t = torch.as_tensor(toks, dtype=torch.int64, device=lg.device)
        out.append((lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]).cpu())
    return torch.cat(out)


def summary(g: torch.Tensor) -> dict:
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean()),
            "other_token_share": float((g > 0).float().mean()),
            "rows": int(g.numel())}


def sequences(sample: list[dict]) -> list[dict]:
    """The reference's input per sampled request: ``prompt`` (int array),
    ``out`` (served tokens) and ``cap_len``."""
    seqs = []
    for r in sample:
        ids = list(map(int, r["prompt"])) + list(map(int, r["out"][:-1]))
        seqs.append({"ids": torch.as_tensor(ids, dtype=torch.int64),
                     "prompt": len(r["prompt"]), "cap_len": r["cap_len"]})
    return seqs


def check(tree: dict, cfg: dict, sample: list[dict], device=None,
          control: bool = False, routes: list | None = None) -> dict:
    """The program's gaps on ``sample`` (and, with ``control``, the gaps
    of the tokens the fp8 control puts first at the same rows, under
    ``"control"``). ``routes``: as :func:`model.logits`'s."""
    model.no_tf32()
    seqs = sequences(sample)
    with torch.no_grad():
        ref = model.logits(tree, cfg, seqs, device=device, routes=routes)
        g = gaps(ref, [r["out"] for r in sample])
        out = summary(g)
        if routes is not None:
            out["gaps"] = g
        if control:
            low = model.logits(tree, cfg, seqs, quant="fp8", device=device)
            picks = [lg.argmax(-1).tolist() for lg in low]
            out["control"] = summary(gaps(ref, picks))
    return out
