"""The port's bf16 train path on a CUDA card against the port on the CPU.

A module, not a script: ``chip_smoke.py``'s ``train_parity_phase`` and the
card test ``test_bf16_train_family_on_card_matches_cpu``
(``tests/test_torch_gpu.py``) load it by path, and
``tests/torch_bf16_parity.py`` takes :class:`ForcedRoutes`,
:func:`flips_at` and :func:`accuracy_ratios` from it for the CPU holds
against the reference. It imports no jax.

For each arch the smoke config at ``param_dtype="bfloat16"``, random
weights from seed 0 with every norm scale drawn off 1, and one
``make_batch`` of 2 x 32 tokens: ``loss_and_grads`` under exact numerics
on the CPU at bf16, on the CPU at float32 on the same bf16-valued weights
(:func:`cpu_runs`), and on the card at bf16. The card's float32 products
sum in cuBLAS's order and its transcendentals are CUDA's; bf16 roundings
carry such differences on through the model as they carry the CPU's own
rounding, so the bound is the CPU's own bf16 error: the card's loss, aux
loss and every gradient leaf within twice the CPU bf16 run's max distance
from the float32 run (``ratio`` <= 1).

MoE routes that flip at a near tie are told apart first, as the CPU tests
tell the port's from the reference's: layer by layer, with the earlier
layers' routes forced to the CPU's (:class:`ForcedRoutes`), every token
whose expert set flips on the card must have a CPU gap between its k-th
and (k+1)-th router probability of at most that layer's max |card - CPU|
probability; the held run then routes every layer as the CPU does
(:func:`family_parity`). :func:`step_parity` holds one train step from
the same state on both devices, the card's routed as the CPU's.
"""
from __future__ import annotations

import contextlib
import functools
import time

import numpy as np

SEQ, BATCH = 32, 2
B1, B2, EPS = 0.9, 0.95, 1e-8  # AdamW's defaults (``optim/adamw.py``)


def smoke_model(arch: str):
    """The bf16 smoke config and its parameters on the CPU: seed 0, every
    norm scale drawn off 1 (bf16-exact values in [0.5, 1.5), seed 5)."""
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import map_tree

    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16")
    params = tf.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)

    def scale(name, t):
        if name.rsplit("/", 1)[-1] != "scale":
            return t
        off = rng.integers(-64, 64, tuple(t.shape)) / 128
        return torch.from_numpy(1 + off).to(t.dtype)

    return cfg, map_tree(scale, params)


class ForcedRoutes:
    """A hook on the port's routing for one run: ``moe.route`` and the aux
    loss (``transformer.load_balance_loss_from_probs``) patched while
    open. MoE layers are numbered in forward order by their router tensor
    (a checkpoint's recompute hands a layer the same tensors, so it keeps
    its number). A layer below ``upto`` takes ``ids[layer]`` (another
    run's top-k ids, (B, S, K) numpy) as its routing and its aux loss's
    top-k, its gates its own probabilities at those ids renormalized;
    every layer's first probabilities and ids are kept in ``probs`` /
    ``ids_seen`` (numpy)."""

    def __init__(self, ids=(), upto: int = 0):
        self.ids, self.upto = list(ids), upto
        self.layer_of: dict = {}
        self.probs: dict = {}
        self.ids_seen: dict = {}
        self.current = None

    def _route(self, p, x, cfg, numerics):
        import torch

        layer = self.layer_of.setdefault(p["router"].data_ptr(),
                                         len(self.layer_of))
        self.current = layer
        probs, idx, gate = self._real_route(p, x, cfg, numerics)
        if layer < self.upto:
            idx = torch.from_numpy(self.ids[layer]).to(torch.int64).to(
                probs.device)
            gate = torch.gather(probs, -1, idx)
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        self.probs.setdefault(layer, probs.detach().cpu().numpy().copy())
        self.ids_seen.setdefault(layer, idx.cpu().numpy().copy())
        return probs, idx, gate

    def _aux(self, probs, cfg, mesh=None):
        import torch

        from repro_torch.models import moe

        if self.current >= self.upto:
            return self._real_aux(probs, cfg, mesh)
        forced = torch.from_numpy(self.ids[self.current]).to(
            torch.int64).reshape(-1, cfg.moe.top_k).to(probs.device)
        real_top_k = moe.top_k
        moe.top_k = lambda pe, k: (None, forced)
        try:
            return self._real_aux(probs, cfg, mesh)
        finally:
            moe.top_k = real_top_k

    def __enter__(self):
        from repro_torch.models import moe
        from repro_torch.models import transformer as tf

        self._real_route, self._real_aux = (moe.route,
                                            tf.load_balance_loss_from_probs)
        moe.route, tf.load_balance_loss_from_probs = self._route, self._aux
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        from repro_torch.models import transformer as tf

        moe.route, tf.load_balance_loss_from_probs = (self._real_route,
                                                      self._real_aux)


def flips_at(ref_probs: np.ndarray, ref_ids: np.ndarray, probs: np.ndarray,
             ids: np.ndarray, k: int) -> dict:
    """One MoE layer's routes against another run's: the tokens whose
    top-k expert set differs (``flipped``), the other run's gap between
    its k-th and (k+1)-th probability at each (``gaps``) and the layer's
    max |probability difference| (``dprob``)."""
    flipped = (np.sort(ids, -1) != np.sort(ref_ids, -1)).any(-1)
    top = -np.sort(-ref_probs, -1)
    return dict(flipped=int(flipped.sum()),
                gaps=(top[..., k - 1] - top[..., k])[flipped],
                dprob=float(np.abs(probs - ref_probs).max()))


def _run(params, batch, cfg, dev, hook=None) -> dict:
    """``loss_and_grads`` (exact numerics) of ``params`` moved to ``dev``:
    loss, aux and the gradients as float32 numpy by leaf path."""
    import contextlib

    from repro_torch.numerics.ops import get_numerics
    from repro_torch.train.step import batch_to, loss_and_grads
    from repro_torch.util.tree import leaves_with_paths, tree_map

    p = tree_map(lambda t: t.to(dev), params)
    with hook if hook is not None else contextlib.nullcontext():
        loss, aux, grads = loss_and_grads(p, batch_to(batch, dev), cfg,
                                          get_numerics("exact"))
    return dict(loss=float(loss), aux=float(aux),
                grads={n: g.detach().float().cpu().numpy()
                       for n, g in leaves_with_paths(grads)})


def ratio(err: float, own: float) -> float:
    """``err`` over twice ``own`` (<= 1: within the bound); 0 / 0 is 0."""
    return 0.0 if err == 0 else (float("inf") if own == 0 else
                                 err / (2 * own))


def accuracy_ratios(got: dict, ref: dict, ref32: dict,
                    at: dict | None = None) -> dict:
    """Per quantity (``loss``, ``aux``, every gradient leaf of these
    ``{"loss", "aux", "grads"}`` runs): ``got``'s max distance from ``at``
    (by default the float32 run ``ref32``) over twice ``ref``'s distance
    from ``ref32`` (a bf16 run's own error). With ``at`` the float32 run:
    <= 1 where ``got``'s bf16 error is within twice ``ref``'s; with ``at``
    ``ref``: <= 1 where ``got`` lies within twice that error of ``ref``."""
    at = ref32 if at is None else at
    out = {k: ratio(abs(got[k] - at[k]), abs(ref[k] - ref32[k]))
           for k in ("loss", "aux")}
    for n, r32 in ref32["grads"].items():
        out[n] = ratio(float(np.abs(got["grads"][n] - at["grads"][n]).max()),
                       float(np.abs(ref["grads"][n] - r32).max()))
    return out


def adamw_gap(g: np.ndarray, dd, mu0, nu0, step: int) -> np.ndarray:
    """Elementwise, the most AdamW's update u at ``step`` (1-based; u =
    m_hat / (sqrt(v_hat) + eps), before weight decay) moves when the
    clipped gradient moves from ``g`` by at most ``dd``, from the same
    moments ``mu0`` / ``nu0``: max |u(x) - u(g)| over x in [g - dd, g +
    dd], in float64 at 17 points across it and at u's stationary point
    without eps, (b2 nu0 / (1 - b2)) / (b1 mu0 / (1 - b1)), where it lies
    inside (u has no other extremum). Where the interval holds the sign
    change of m that reaches 2: at the first step, the sign ties of g."""
    g, dd, mu0, nu0 = (np.asarray(t, np.float64) for t in (g, dd, mu0, nu0))
    bc1, bc2 = 1 - B1 ** step, 1 - B2 ** step

    def u(x):
        m = B1 * mu0 + (1 - B1) * x
        v = B2 * nu0 + (1 - B2) * x * x
        return (m / bc1) / (np.sqrt(v / bc2) + EPS)

    a, c = B1 * mu0 / (1 - B1), B2 * nu0 / (1 - B2)
    with np.errstate(divide="ignore", invalid="ignore"):
        star = np.where(a != 0, c / np.where(a != 0, a, 1), g)
    u0 = u(g)
    pts = [g + dd * t for t in np.linspace(-1, 1, 17)]
    pts.append(np.clip(star, g - dd, g + dd))
    return np.max([np.abs(u(x) - u0) for x in pts], axis=0)


def adamw_max(step: int) -> float:
    """The largest |u| AdamW's update can take at ``step`` (1-based) for
    any gradients: m_hat and v_hat weigh the same gradients by w_i and
    w'_i, so by Cauchy-Schwarz |m_hat| <= sqrt(sum w_i^2 / w'_i)
    sqrt(v_hat) (1 at the first step, 1.001 at the third)."""
    bc1, bc2 = 1 - B1 ** step, 1 - B2 ** step
    return float(sum(((1 - B1) * B1 ** (step - i) / bc1) ** 2
                     / ((1 - B2) * B2 ** (step - i) / bc2)
                     for i in range(1, step + 1)) ** 0.5)


@functools.lru_cache(maxsize=1)
def cpu_runs(arch: str) -> dict:
    """``arch``'s bf16 smoke model (:func:`smoke_model`), its batch, and
    its ``loss_and_grads`` on the CPU at bf16 (``cpu``) and at float32 on
    the same bf16-valued weights (``cpu32``); ``ids``: the bf16 run's
    top-k expert ids per MoE layer, in forward order."""
    import torch

    from repro_torch.data import make_batch
    from repro_torch.models import transformer as tf
    from repro_torch.util.tree import tree_map

    cfg, params = smoke_model(arch)
    batch = make_batch(cfg, SEQ, BATCH)
    cpu_dev = torch.device("cpu")
    moe_layers = sum(k.ffn == "moe" for *_, k in tf.layer_slots(cfg))
    seen = ForcedRoutes()
    cpu = _run(params, batch, cfg, cpu_dev, seen if moe_layers else None)
    cpu32 = _run(tree_map(lambda t: t.to(torch.float32), params), batch,
                 cfg.replace(param_dtype="float32"), cpu_dev)
    return dict(cfg=cfg, params=params, batch=batch, cpu=cpu, cpu32=cpu32,
                probs=[seen.probs[i] for i in range(moe_layers)],
                ids=[seen.ids_seen[i] for i in range(moe_layers)])


def forced(ids: list):
    """Every MoE layer routed by ``ids`` (none: no hook)."""
    return (ForcedRoutes(ids, upto=len(ids)) if ids
            else contextlib.nullcontext())


def family_parity(arch: str, dev) -> dict:
    """The hold for one family: the card's bf16 ``loss_and_grads`` against
    the CPU's bf16 and float32 runs (:func:`cpu_runs`). Returns ``ratio``
    (the largest of the card's distances over their bounds), the quantity
    it was found at, per-layer ``flips`` and ``ok``."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import get_numerics
    from repro_torch.util.tree import tree_map

    t0 = time.perf_counter()
    r = cpu_runs(arch)
    cfg, params, batch, ids = r["cfg"], r["params"], r["batch"], r["ids"]
    flips, ties = [], True
    for layer in range(len(ids)):
        hook = ForcedRoutes(ids, upto=layer)
        with hook, torch.no_grad():
            tf.loss_fn(tree_map(lambda t: t.to(dev), params),
                       {k: torch.as_tensor(v).to(dev)
                        for k, v in batch.items()}, cfg,
                       get_numerics("exact"))
        f = flips_at(r["probs"][layer], ids[layer], hook.probs[layer],
                     hook.ids_seen[layer], cfg.moe.top_k)
        ties = ties and bool((f["gaps"] <= f["dprob"]).all())
        flips.append({"flipped": f["flipped"], "gaps": f["gaps"].tolist(),
                      "dprob": f["dprob"]})
    card = _run(params, batch, cfg, dev, forced(ids))
    ratios = accuracy_ratios(card, r["cpu"], r["cpu32"])
    worst = max(ratios, key=ratios.get)
    return {"arch": arch, "ratio": ratios[worst], "at": worst,
            "loss": card["loss"], "cpu_loss": r["cpu"]["loss"],
            "cpu32_loss": r["cpu32"]["loss"], "flips": flips,
            "ok": bool(ratios[worst] <= 1 and ties),
            "s": time.perf_counter() - t0}


def step_parity(arch: str, dev) -> dict:
    """One train step (exact numerics, AdamW at lr 1e-3, no warmup) from
    the same state on the CPU and on the card, the card's MoE layers
    routed as the CPU's (:func:`family_parity` shows the flips to be
    ties). Held, from :func:`family_parity`'s bound alone:

    * the loss and aux loss within twice the CPU's own bf16 error, as
      there; the learning rates equal;
    * the gradients: :func:`family_parity` holds the card's within 2
      ``own`` of the float32 run, ``own`` the CPU's max bf16 error per
      leaf, so within D = 3 ``own`` of the CPU's (scaled by the card's
      clip, plus the two clips' difference on the CPU's gradient). So the
      gradient norms lie within the norm of D, and ``mu`` and ``nu``
      within (1 - b1) D and (1 - b2) D (2 |g| + D) of the CPU's, g the
      CPU's clipped gradient;
    * the float32 master: AdamW's first update is u(g) = g / (|g| + eps),
      so the masters lie within lr :func:`adamw_gap` (g, D) of each
      other. Where |g| <= D the sign of g is a tie and that reaches 2 lr;
      elsewhere it is the update's own rounding, a few float32 ulps where
      |g| >> eps. Every bound adds the float32 roundings of the update;
    * the card's bf16 parameters its master cast, and at most 1% of them
      apart from the CPU's.

    Returns the largest ratio of each distance to its bound
    (``mu_ratio``, ``nu_ratio``, ``master_ratio``, ``grad_norm_ratio``,
    ``loss_ratio``, ``aux_ratio``; ``master_untied_ratio`` the master's
    outside the sign-tie set), the share of elements in that set
    (``tie_share``) and of bf16 parameters that differ, and ``ok``."""
    import torch

    from repro_torch.optim import adamw_init
    from repro_torch.train import StepConfig, TrainState, make_train_step
    from repro_torch.util.tree import leaves_with_paths, tree_map

    r = cpu_runs(arch)
    cfg, params, batch = r["cfg"], r["params"], r["batch"]
    sc = StepConfig(peak_lr=1e-3, warmup=0, total_steps=10)
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        p = tree_map(lambda t: t.to(d), params)
        with (forced(r["ids"]) if name == "card"
              else contextlib.nullcontext()):
            state, m = make_train_step(cfg, sc)(
                TrainState(p, adamw_init(p), None), batch, 0)
        out[name] = (state, {k: float(v) for k, v in m.items()})
    (cpu, cm), (card, km) = out["cpu"], out["card"]
    lr = cm["lr"]
    clip_r, clip_c = (min(1.0, 1.0 / m["grad_norm"]) for m in (cm, km))

    def named(tree):
        return {n: t.detach().float().cpu().numpy()
                for n, t in leaves_with_paths(tree)}

    mu_r, mu_c = named(cpu.opt.mu), named(card.opt.mu)
    nu_r, nu_c = named(cpu.opt.nu), named(card.opt.nu)
    w_r, w_c = named(cpu.opt.master), named(card.opt.master)
    p_r, p_c = named(cpu.params), named(card.params)
    cast = all(torch.equal(a, b.to(a.dtype)) for (_, a), (_, b) in zip(
        leaves_with_paths(card.params), leaves_with_paths(card.opt.master)))
    worst = dict(mu=0.0, nu=0.0, master=0.0)
    norm_d = ties = differ = total = 0
    untied = 0.0
    f32 = 2.0 ** -22  # two float32 roundings, relative

    def over(err, bound):
        return float(np.max(np.where(err == 0, 0.0, err / np.maximum(
            bound, np.finfo(np.float32).tiny))))

    for n, g32 in r["cpu32"]["grads"].items():
        own = float(np.abs(r["cpu"]["grads"][n] - g32).max())
        g = mu_r[n].astype(np.float64) / (1 - B1)
        dd = (clip_c * 3 * own + abs(1 - clip_c / clip_r) * np.abs(g)
              + f32 * np.abs(g))
        norm_d += float((dd ** 2).sum())
        worst["mu"] = max(worst["mu"], over(
            np.abs(mu_c[n] - mu_r[n]), (1 - B1) * dd + f32 * np.abs(mu_r[n])))
        worst["nu"] = max(worst["nu"], over(
            np.abs(nu_c[n] - nu_r[n]),
            (1 - B2) * dd * (2 * np.abs(g) + dd) + f32 * nu_r[n]))
        du = adamw_gap(g, dd, 0.0, 0.0, 1)
        dw = np.abs(w_c[n] - w_r[n])
        bound = lr * (du + 2.0 ** -20) + f32 * np.abs(w_r[n])
        worst["master"] = max(worst["master"], over(dw, bound))
        tied = np.abs(g) <= dd
        if not tied.all():
            untied = max(untied, over(dw[~tied], bound[~tied]))
        ties += int(tied.sum())
        differ += int((p_c[n] != p_r[n]).sum())
        total += g.size
    gn_ratio = (abs(km["grad_norm"] - cm["grad_norm"])
                / (norm_d ** 0.5 + f32 * cm["grad_norm"]))
    c, c32 = r["cpu"], r["cpu32"]
    loss_ratio, aux_ratio = (ratio(abs(km[k] - c32[k]), abs(c[k] - c32[k]))
                             for k in ("loss", "aux"))
    res = {"arch": arch, "loss": km["loss"], "cpu_loss": cm["loss"],
           "lr_equal": km["lr"] == lr, "loss_ratio": loss_ratio,
           "aux_ratio": aux_ratio, "grad_norm_ratio": gn_ratio,
           **{f"{k}_ratio": v for k, v in worst.items()},
           "master_untied_ratio": untied,
           "tie_share": ties / total, "params_differ": differ / total,
           "params_cast": cast}
    res["ok"] = bool(res["lr_equal"] and cast and differ <= 0.01 * total
                     and max(loss_ratio, aux_ratio, gn_ratio,
                             *worst.values()) <= 1)
    return res
