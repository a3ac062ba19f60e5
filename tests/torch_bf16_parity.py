"""Shared by ``tests/test_torch_bf16_*.py``: the port's bfloat16 path (the
dtype the card serves) against the reference on the smoke configs at
``param_dtype="bfloat16"``.

Two things stand between the reference and a CPU run in bf16:

* **XLA's CPU backend has no bf16 x bf16 -> float32 dot** (``DotThunk``:
  ``UNIMPLEMENTED ... BF16 x BF16 = F32``), which the reference's expert
  products, attention and SSD chunk products ask for with
  ``jnp.einsum(..., preferred_element_type=float32)``. :data:`SHIM` stands
  in for ``jax.numpy`` in those modules (:func:`patch_reference`): every
  name is ``jax.numpy``'s own, except that such an einsum upcasts its bf16
  operands first. A bf16 x bf16 product is exact in float32, so this is
  the float32-accumulated product that the einsum asks for.
* **XLA's excess precision.** By default XLA may drop a bf16 rounding
  that its fusions make redundant (``xla_allow_excess_precision``): a
  bf16 residual add fused into the LayerNorm that upcasts it reads the
  unrounded float32 sum. The reference is compiled here with that option
  off (:func:`ref_jit`), so every ``astype`` it writes rounds, as every
  one of the port's does; ``test_torch_bf16_ssm_encdec.py`` shows the
  option alone moves Whisper's logits.

One thing stands between the two packages' interp-fused arithmetic: a
bf16 x bf16 -> bf16 product (``x @ w``) accumulates in float32 in the CPU
library's order, oneDNN's in the port and XLA's in the reference. An
element whose exact value lies within that reassociation of a bf16
rounding boundary rounds to neighbouring bf16 values in the two packages
(:func:`near_ties`), and the model carries the flip on. Under
:class:`ReferenceGemm` the port takes those products from XLA's CPU dot
(and nothing else), and every family's logits and caches are bitwise the
reference's (:func:`hold_family` with ``gemm=True``); without it they are
bitwise where no such tie falls on the held inputs, else within a bound.

Holds (:func:`hold_family`): prefill of :data:`PROMPT` tokens, then
:data:`STEPS` decodes teacher-forced with the reference's greedy tokens.
Interp-fused: bitwise, or within one bf16 ulp of the step's largest
|logit| where a tie falls. Exact (``jax.nn`` / ``jax.lax`` against
``torch`` transcendentals and float32 products in another order, through
bf16 roundings that amplify them): max |port - reference| over the run
within twice the reference's own max distance from its float32 run on
the same bf16-valued weights and tokens; so too Jamba's interp-fused run
on prompts where a tie falls early and its eight layers carry it on.
Greedy tokens equal wherever the reference's top-2 gap exceeds twice the
bound; cache positions bitwise.

The train path (``tests/test_torch_bf16_train_*.py``, the section
"training" below): ``loss_and_grads`` on a ``make_batch`` of 2 x 32
tokens, bitwise in the loss with the forward bf16 products and the CE
from XLA (:func:`hold_train_gemm`), within twice the reference's own bf16
error under exact numerics with MoE routes forced after the flip rule
(:func:`hold_train_exact`), and the train step (:func:`hold_train_step`).
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import pathlib
import types
from typing import Callable, NamedTuple

from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.attention as jattn
import repro.models.moe as jmoe
import repro.models.ssm as jssm
from repro.api import default_explorer
from repro.configs import base as jbase
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro_torch.api.library import InterpLibrary
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.data import make_batch
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics
from repro_torch.train.step import batch_to, loss_and_grads
from repro_torch.util.tree import leaves_with_paths

_spec = importlib.util.spec_from_file_location(
    "train_parity",
    pathlib.Path(__file__).resolve().parents[1] / "tools" / "train_parity.py")
train_parity = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(train_parity)
ForcedRoutes, accuracy_ratios, flips_at = (
    train_parity.ForcedRoutes, train_parity.accuracy_ratios,
    train_parity.flips_at)

CACHE = 32
PROMPT = 16
STEPS = 3
# the reference modules whose float32-preferred einsums see bf16 operands
REF_MODULES = (jattn, jmoe, jssm)
COMPILER_OPTIONS = {"xla_allow_excess_precision": False}


def _einsum(*args, preferred_element_type=None, **kw):
    """``jnp.einsum``; asked for float32, bf16 operands are upcast first."""
    if (preferred_element_type is not None
            and np.dtype(preferred_element_type) == np.float32):
        args = tuple(a.astype(jnp.float32)
                     if getattr(a, "dtype", None) == jnp.bfloat16 else a
                     for a in args)
    return jnp.einsum(*args, preferred_element_type=preferred_element_type,
                      **kw)


class _Shim(types.ModuleType):
    """``jax.numpy`` with :func:`_einsum` in place of ``einsum``."""

    def __getattr__(self, name):
        return getattr(jnp, name)


SHIM = _Shim("jax.numpy")
SHIM.einsum = _einsum


def patch_reference(monkeypatch) -> None:
    for mod in REF_MODULES:
        monkeypatch.setattr(mod, "jnp", SHIM)


def ref_jit(fn, **static):
    """``fn`` with ``static`` bound, jitted with every bf16 rounding kept."""
    return jax.jit(functools.partial(fn, **static),
                   compiler_options=COMPILER_OPTIONS)


@functools.lru_cache(maxsize=None)
def libs():
    return default_explorer().compile(), InterpLibrary.default_library("cpu")


def numerics(name: str):
    jlib, lib = libs()
    interp = name != "exact"
    return (jax_get_numerics(name, jlib if interp else None),
            get_numerics(name, lib if interp else None))


@functools.lru_cache(maxsize=None)
def bf16_pair(arch: str):
    """The smoke configs of ``arch`` at bfloat16 and reference parameters
    with every norm scale drawn off 1 (bf16-exact values in [0.5, 1.5)),
    as ``tests/test_torch_model.py``'s ``_bf16_params``; the port's carried
    over by ``params_from_jax``. Also the float32 config and the same
    bf16-valued parameters in float32 (the reference's own bf16 distance)."""
    jcfg = jbase.get_smoke_config(arch).replace(param_dtype="bfloat16")
    cfg = base.get_smoke_config(arch).replace(param_dtype="bfloat16")
    rng = np.random.default_rng(5)

    def scales(tree):
        return {k: scales(v) if isinstance(v, dict) else
                ((1 + rng.integers(-64, 64, v.shape) / 128).astype(v.dtype)
                 if k == "scale" else v) for k, v in tree.items()}

    tree = scales(jax.tree.map(np.asarray,
                               jtf.init_params(jax.random.key(0), jcfg)))
    f32 = jax.tree.map(lambda t: jnp.asarray(t.astype(np.float32)), tree)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jax.tree.map(jnp.asarray, tree),
                params=params_from_jax(tree, cfg, "cpu"),
                jcfg32=jbase.get_smoke_config(arch), jparams32=f32)


@functools.lru_cache(maxsize=None)
def inputs(arch: str) -> dict:
    """Seeded prompt tokens, and Whisper's frames or InternVL2's patches
    (float32, as their stubs hand them over)."""
    cfg = base.get_smoke_config(arch)
    rng = np.random.default_rng(0)
    out = {"toks": rng.integers(0, cfg.vocab_size, (2, PROMPT)).astype(
        np.int32)}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (2, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def cache_len(ins: dict) -> int:
    """:data:`CACHE`, or the prompt and its decodes where they need more."""
    return max(CACHE, ins["toks"].shape[1] + STEPS)


def prompt(arch: str, n: int, seed: int) -> dict:
    """:func:`inputs` with ``n`` seeded prompt tokens in place of its own."""
    out = dict(inputs(arch))
    out["toks"] = np.random.default_rng(seed).integers(
        0, base.get_smoke_config(arch).vocab_size, (2, n)).astype(np.int32)
    return out


def run_reference(jcfg, jparams, jnum, ins: dict, feed=None,
                  compiler_options=COMPILER_OPTIONS):
    """Prefill, then :data:`STEPS` decodes, each fed its greedy token (or
    ``feed``'s (token, position) pairs). Returns the logits per step
    (float32), the feed and the final cache."""
    kw = {}
    if "frames" in ins:
        kw["enc_frames"] = jnp.asarray(ins["frames"])
    if "patches" in ins:
        kw["frontend_emb"] = jnp.asarray(ins["patches"])
    jit = functools.partial(jax.jit, compiler_options=compiler_options)
    pre = jit(functools.partial(jtf.prefill, cfg=jcfg, numerics=jnum,
                                cache_len=cache_len(ins)))
    dec = jit(functools.partial(jtf.decode_step, cfg=jcfg, numerics=jnum))
    log, cache, cross = pre(jparams, jnp.asarray(ins["toks"]), **kw)
    dkw = {} if cross is None else {"cross": cross}
    out = [np.asarray(log).astype(np.float32)]
    fed = []
    pos = np.full(2, ins["toks"].shape[1], np.int32)
    for i in range(STEPS):
        tok = (out[-1][:, 0].argmax(-1)[:, None].astype(np.int32)
               if feed is None else feed[i][0])
        fed.append((tok, pos))
        log, cache = dec(jparams, jnp.asarray(tok), jnp.asarray(pos), cache,
                         **dkw)
        out.append(np.asarray(log).astype(np.float32))
        pos = pos + 1
    return out, fed, cache


class _Op(NamedTuple):
    """One torch function and its XLA twin on the same operands; ``out``:
    the result's dtype (None: the first operand's)."""

    torch: Callable
    xla: Callable
    out: torch.dtype | None = None


_JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


class _FromXla(torch.autograd.Function):
    """``op.torch(*ts)`` with its forward value from XLA (``op.xla`` on the
    same operands) and its backward torch's own on the same operands,
    with :class:`ReferenceGemm` off inside it: the gradient's arithmetic
    is the port's."""

    @staticmethod
    def forward(ctx, op, *ts):
        ctx.op = op
        ctx.save_for_backward(*ts)
        out = op.xla(*(jnp.asarray(t.detach().float().numpy(),
                                   _JAX_DTYPES[t.dtype]) for t in ts))
        return torch.from_numpy(np.array(out, np.float32)).to(
            op.out or ts[0].dtype)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[1:]
        ts = ctx.saved_tensors  # a checkpoint recomputes here: mode on
        with torch._C.DisableTorchFunction(), torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(ts, need)]
            gs = iter(torch.autograd.grad(ctx.op.torch(*xs),
                                          [x for x in xs if x.requires_grad],
                                          g, allow_unused=True))
        return (None, *(next(gs) if n else None for n in need))


_MATMUL = _Op(torch.matmul, jax.jit(lambda a, b: a @ b))


class ReferenceGemm(TorchFunctionMode):
    """Inside, a bf16 x bf16 ``matmul`` / ``@`` is XLA's CPU dot of the same
    operands (the reference's accumulation order), rounded to bf16 as
    XLA rounds it; every other call runs as it is. The product is
    differentiable (:class:`_FromXla`: its backward is torch's).

    A ``torch.autograd.grad`` called inside runs with the mode still on,
    so a checkpoint's recompute in the backward pass (remat, the loss's CE
    chunks) takes its products from XLA as the forward did: a mode is off
    inside its own handler, so the handler calls the autograd engine
    itself with the mode pushed again. ``calls`` counts the products
    taken, recomputed ones included."""

    _ops = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func in self._ops and len(args) == 2 and not kwargs
                and all(isinstance(t, torch.Tensor)
                        and t.dtype == torch.bfloat16 for t in args)):
            self.calls += 1
            return _FromXla.apply(_MATMUL, *args)
        if func is torch.autograd.grad:
            return self._grad(*args, **kwargs)
        return func(*args, **kwargs)

    def _grad(self, outputs, inputs, grad_outputs=None, retain_graph=None,
              create_graph=False, allow_unused=None, **_kw):
        """``torch.autograd.grad`` (tensor gradients, none batched) run by
        the engine with this mode on."""
        from torch.autograd.graph import _engine_run_backward

        outs = ((outputs,) if isinstance(outputs, torch.Tensor)
                else tuple(outputs))
        ins = (inputs,) if isinstance(inputs, torch.Tensor) else tuple(inputs)
        gos = (tuple(torch.ones_like(o) for o in outs) if grad_outputs is None
               else ((grad_outputs,) if isinstance(grad_outputs, torch.Tensor)
                     else tuple(grad_outputs)))
        with self:
            return _engine_run_backward(
                outs, gos, create_graph if retain_graph is None
                else retain_graph, create_graph, ins, bool(allow_unused),
                accumulate_grad=False)


def run_port(cfg, params, tnum, ins: dict, feed):
    """The port's prefill and decodes on ``feed`` (the reference's tokens):
    the logits per step as returned (bf16) and the final cache."""
    kw = {}
    if "frames" in ins:
        kw["cross"] = tf.encoder_forward(
            params["encoder"], torch.from_numpy(ins["frames"]), cfg, tnum)
    pkw = dict(kw)
    if "patches" in ins:
        pkw["frontend_emb"] = torch.from_numpy(ins["patches"])
    log, cache = tf.prefill(params, torch.from_numpy(ins["toks"]).long(),
                            cfg, tnum, cache_len(ins), **pkw)
    out = [log]
    for tok, pos in feed:
        log, cache = tf.decode_step(params, torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos), cache, cfg, tnum,
                                    **kw)
        out.append(log)
    return out, cache


def layer_leaves(tcache, cfg, i: int) -> list[torch.Tensor]:
    """Layer ``i``'s cache leaves in the port's stacks."""
    *_, ci, kind = tf.layer_slots(cfg)[i]
    if isinstance(tcache, tf.MixedCache):
        tcache = tcache.ssm if kind.mixer == "ssm" else tcache.kv
    return [t[ci] for t in tcache]


def ref_layer_leaves(jcache, cfg, i: int) -> list[np.ndarray]:
    """Layer ``i``'s leaves in the reference's per-segment tree."""
    seg, j, r, _ci, _kind = tf.layer_slots(cfg)[i]
    return [np.asarray(t) if r is None else np.asarray(t)[r]
            for t in jcache[seg][j]]


def assert_cache(tcache, jcache, cfg, bitwise: bool) -> int:
    """Every leaf of the reference's shape and dtype, every integer leaf
    (the slots' positions) bitwise; with ``bitwise`` every bf16 leaf too
    (K / V, MLA's latent, the SSM's conv window) and the float32 SSM state
    within float32 reassociation of its products (2^-16 of its largest
    magnitude). Returns the number of integer leaves compared."""
    n = 0
    for i in range(cfg.n_layers):
        got, want = layer_leaves(tcache, cfg, i), ref_layer_leaves(
            jcache, cfg, i)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            if not g.dtype.is_floating_point or (
                    bitwise and g.dtype != torch.float32):
                np.testing.assert_array_equal(g.float().numpy(),
                                              w.astype(np.float32))
            elif bitwise:
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=0,
                    atol=2.0 ** -16 * float(np.abs(w).max()))
            n += not g.dtype.is_floating_point
    return n


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def assert_greedy(want: np.ndarray, got: np.ndarray, tol: float) -> None:
    """Greedy tokens equal wherever the reference's top-2 gap exceeds
    twice ``tol``."""
    ref = want.reshape(-1, want.shape[-1])
    got = got.reshape(ref.shape)
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(ref.argmax(-1)[clear], got.argmax(-1)[clear])


def near_ties(a: np.ndarray, b: np.ndarray, got: np.ndarray,
              want: np.ndarray) -> np.ndarray:
    """For a bf16 product ``a @ b`` (float32 accumulation of exact
    products) that two libraries rounded to ``got`` and ``want``: where
    they differ, whether the exact (float64) product lies within the
    float32 summation bound K * 2^-24 * (|a| @ |b|) of the midpoint
    between them, so that a sum in either order can land on either side
    of that rounding boundary. True where they agree."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    exact, mag = a64 @ b64, np.abs(a64) @ np.abs(b64)
    g, w = got.astype(np.float64), want.astype(np.float64)
    slack = a.shape[-1] * 2.0 ** -24 * mag
    return (g == w) | (np.abs(exact - (g + w) / 2) <= slack)


@functools.lru_cache(maxsize=None)
def reference(arch: str, name: str, n: int | None, f32: bool = False):
    """:func:`run_reference` of ``arch``'s bf16 pair on :func:`inputs` (or
    a prompt of ``n`` tokens, seeded with ``n``); with ``f32`` the float32
    run on the same bf16-valued weights and the bf16 run's tokens. The
    shim must be in place (:func:`patch_reference`)."""
    s = bf16_pair(arch)
    ins = inputs(arch) if n is None else prompt(arch, n, n)
    jnum = numerics(name)[0]
    if not f32:
        return run_reference(s["jcfg"], s["jparams"], jnum, ins)
    feed = reference(arch, name, n)[1]
    return run_reference(s["jcfg32"], s["jparams32"], jnum, ins, feed=feed)


def hold_family(arch: str, name: str, bound: str, *, gemm: bool = False,
                n: int | None = None) -> list[float]:
    """``arch``'s bf16 smoke model in both packages on :func:`inputs` (or
    a prompt of ``n`` tokens), the port fed the reference's greedy tokens.
    ``bound``:
    ``"bitwise"``; ``"ulp"``, one bf16 ulp of each step's largest |logit|;
    ``"f32"``, twice the reference's own max distance over the run from
    its float32 run on the same bf16-valued weights and tokens (exact
    numerics always). Greedy tokens equal wherever the reference's top-2
    gap exceeds twice the bound. ``gemm`` runs the port under
    :class:`ReferenceGemm` and holds every cache leaf too
    (:func:`assert_cache`), else the positions. Returns each step's max
    |port - reference|."""
    s = bf16_pair(arch)
    ins = inputs(arch) if n is None else prompt(arch, n, n)
    tnum = numerics(name)[1]
    want, feed, jcache = reference(arch, name, n)
    if gemm:
        with ReferenceGemm() as mode:
            got, tcache = run_port(s["cfg"], s["params"], tnum, ins, feed)
        assert mode.calls > 0
    else:
        got, tcache = run_port(s["cfg"], s["params"], tnum, ins, feed)
    n_pos = assert_cache(tcache, jcache, s["cfg"], gemm)
    assert n_pos == sum(k.mixer != "ssm" for *_, k in tf.layer_slots(
        s["cfg"]))
    if name == "exact" or bound == "f32":
        ref32 = reference(arch, name, n, f32=True)[0]
        tol = 2 * max(float(np.abs(w - r).max())
                      for w, r in zip(want, ref32))
        assert tol > 0
        bounds = [tol] * len(want)
    else:
        bounds = [0.0 if bound == "bitwise" else bf16_ulp(np.abs(w).max())
                  for w in want]
    diffs = []
    for g, w, tol in zip(got, want, bounds):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        g = g.float().numpy()
        assert np.isfinite(g).all()
        diffs.append(float(np.abs(g - w).max()))
        assert diffs[-1] <= tol, (diffs, bounds)
        assert_greedy(w, g, tol)
    return diffs


# --------------------------------------------------------------- training
#
# The train path at bf16 (``tests/test_torch_bf16_train_*.py``): the loss
# and every gradient leaf of ``loss_fn`` on :func:`train_batch`, and the
# train step. Leaves are compared by path name in float32.

TRAIN_SEQ, TRAIN_BATCH = 32, 2


@functools.lru_cache(maxsize=None)
def train_batch(arch: str, step: int = 0) -> dict:
    """``make_batch`` of ``arch``'s smoke config at ``step``:
    :data:`TRAIN_BATCH` rows of :data:`TRAIN_SEQ` tokens (numpy, bitwise
    the reference's; Whisper's frames and InternVL2's patches included)."""
    return make_batch(base.get_smoke_config(arch), TRAIN_SEQ, TRAIN_BATCH,
                      step=step)


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def named(tree) -> dict:
    """Leaf path -> float32 numpy array, for either package's tree."""
    return {n: (t.detach().float().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t).astype(np.float32))
            for n, t in leaves_with_paths(tree)}


class _Proxy(types.ModuleType):
    """``base`` with the attributes ``over`` in place of its own."""

    def __init__(self, base, **over):
        super().__init__(base.__name__)
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


@contextlib.contextmanager
def reference_routes(seen: list):
    """While open, the reference's routing top-k (``jax.lax.top_k`` on the
    (B, S, E) router probabilities in ``repro.models.moe``) appends each MoE
    layer's probabilities and expert ids to ``seen`` through an ordered
    ``jax.debug.callback``, in layer order; the aux loss's top-k (on the
    flattened (B * S, E) probabilities) runs as it is."""
    def top_k(x, k):
        vals, idx = jax.lax.top_k(x, k)
        if x.ndim == 3:
            jax.debug.callback(
                lambda p, i: seen.append((np.asarray(p), np.asarray(i))),
                x, idx, ordered=True)
        return vals, idx

    real = jmoe.jax
    jmoe.jax = _Proxy(jax, lax=_Proxy(jax.lax, top_k=top_k))
    try:
        yield seen
    finally:
        jmoe.jax = real


@functools.lru_cache(maxsize=None)
def ref_train(arch: str, name: str, f32: bool = False) -> dict:
    """The reference's loss, aux and gradients (``jax.value_and_grad`` of
    ``loss_fn``) on :func:`train_batch` with ``arch``'s bf16 pair, or with
    ``f32`` its float32 config on the same bf16-valued weights. The shim
    must be in place (:func:`patch_reference`)."""
    s = bf16_pair(arch)
    jcfg, jp = ((s["jcfg32"], s["jparams32"]) if f32
                else (s["jcfg"], s["jparams"]))
    jnum = numerics(name)[0]
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, b, jcfg, jnum), has_aux=True),
        compiler_options=COMPILER_OPTIONS)(jp, jax_batch(train_batch(arch)))
    return dict(loss=float(loss), aux=float(m["aux"]), grads=named(g))


@functools.lru_cache(maxsize=None)
def ref_routes(arch: str, name: str) -> tuple:
    """Each MoE layer's router probabilities and top-k ids in the
    reference's bf16 forward on :func:`train_batch` (one jitted
    ``loss_fn`` under :func:`reference_routes`), and that run's loss."""
    s = bf16_pair(arch)
    seen: list = []
    with reference_routes(seen):
        loss, _ = jax.jit(functools.partial(
            jtf.loss_fn, cfg=s["jcfg"], numerics=numerics(name)[0]),
            compiler_options=COMPILER_OPTIONS)(
                s["jparams"], jax_batch(train_batch(arch)))
        jax.effects_barrier()
    return tuple(seen), float(loss)


@contextlib.contextmanager
def reference_ce():
    """While open, the port's ``chunked_ce_loss`` (the mean CE over the
    final hidden states) takes its value from the reference's own
    (``jtf.chunked_ce_loss``, jitted on the same hidden states, head and
    labels) and its backward from the port's: the CE's float32
    ``logsumexp`` and token sum are XLA's (its exp, log and summation
    order), which torch's differ from by float32 ulps."""
    real = tf.chunked_ce_loss

    def ce(p_embed, h, labels, mask, mesh=None, vocab=None):
        names = sorted(p_embed)
        lab, msk = (jnp.asarray(t.numpy()) for t in (labels, mask))
        op = _Op(lambda h_, *ws: real(dict(zip(names, ws)), h_, labels,
                                      mask, mesh, vocab),
                 jax.jit(lambda h_, *ws: jtf.chunked_ce_loss(
                     dict(zip(names, ws)), h_, lab, msk),
                     compiler_options=COMPILER_OPTIONS), torch.float32)
        return _FromXla.apply(op, h, *(p_embed[n] for n in names))

    tf.chunked_ce_loss = ce
    try:
        yield
    finally:
        tf.chunked_ce_loss = real


def port_train(arch: str, name: str, *, gemm: bool = False) -> dict:
    """The port's ``loss_and_grads`` on :func:`train_batch` with ``arch``'s
    bf16 pair; ``gemm`` under :class:`ReferenceGemm` and
    :func:`reference_ce`. The gradients' dtypes in ``dtypes``."""
    s = bf16_pair(arch)
    batch = batch_to(train_batch(arch), "cpu")
    run = functools.partial(loss_and_grads, s["params"], batch, s["cfg"],
                            numerics(name)[1])
    if gemm:
        with ReferenceGemm() as mode, reference_ce():
            loss, aux, grads = run()
        assert mode.calls > 0
    else:
        loss, aux, grads = run()
    return dict(loss=float(loss), aux=float(aux), grads=named(grads),
                dtypes={n: t.dtype for n, t in leaves_with_paths(grads)})


def assert_grad_dtypes(got: dict, arch: str) -> None:
    """Each gradient in its parameter's dtype (bf16, the router and the
    SSM's ``a_log`` / ``dt_bias`` / ``d_skip`` float32), as the
    reference's."""
    want = {n: t.dtype for n, t in leaves_with_paths(
        bf16_pair(arch)["params"])}
    assert got["dtypes"] == want
    assert torch.bfloat16 in want.values()


def gemm_ulps(got: dict, want: dict) -> dict:
    """Per leaf: max |port - reference| in bf16 ulps of the reference's
    largest |gradient| (0 where both are all zero)."""
    out = {}
    for n, r in want["grads"].items():
        err = float(np.abs(got["grads"][n] - r).max())
        scale = float(np.abs(r).max())
        out[n] = float(err / bf16_ulp(scale)) if scale else (
            0.0 if err == 0 else np.inf)
    return out


def own_ratios(got: dict, want: dict, want32: dict) -> dict:
    """Per quantity (``loss``, ``aux``, every gradient leaf): max |port -
    reference| over twice the reference's own bf16-versus-float32 max
    distance (<= 1 is within the bound; the serving holds' form)."""
    return accuracy_ratios(got, want, want32, at=want)


def route_flips(arch: str, name: str = "exact") -> list[dict]:
    """Layer by layer, the port's bf16 forward on :func:`train_batch` with
    the routes of every earlier MoE layer forced to the reference's
    (:class:`ForcedRoutes`): at that layer the tokens whose set of top-k
    experts differs from the reference's (``flipped``), the reference's
    gap between its k-th and (k+1)-th probability at each of them
    (``gaps``), and the layer's max |port - reference| router probability
    (``dprob``)."""
    s = bf16_pair(arch)
    ref, loss = ref_routes(arch, name)
    # the routes are those of the run the exact hold compares with
    assert loss == ref_train(arch, name)["loss"]
    ids = [i for _, i in ref]
    batch = batch_to(train_batch(arch), "cpu")
    out = []
    for layer, (rprobs, rids) in enumerate(ref):
        with ForcedRoutes(ids, upto=layer) as hook, torch.no_grad():
            tf.loss_fn(s["params"], batch, s["cfg"], numerics(name)[1])
        assert len(hook.layer_of) == len(ref)
        out.append(dict(layer=layer, **flips_at(
            rprobs, rids, hook.probs[layer], hook.ids_seen[layer],
            s["cfg"].moe.top_k)))
    return out


def port_train_forced(arch: str, name: str = "exact") -> dict:
    """:func:`port_train` with every MoE layer routed as the reference
    routes it (:class:`ForcedRoutes`)."""
    ids = [i for _, i in ref_routes(arch, name)[0]]
    with ForcedRoutes(ids, upto=len(ids)) as hook:
        out = port_train(arch, name)
    assert len(hook.layer_of) == len(ids)
    return out


STEP = dict(peak_lr=1e-3, warmup=0, total_steps=10)


def train_steps(arch: str, microbatches: int, n: int,
                compress: bool = False, carry: bool = True):
    """``n`` steps of both packages' ``make_train_step`` under interp
    numerics bound to the default library, from one state (``arch``'s bf16
    pair, a fresh AdamW state, with ``compress`` a zero error-feedback
    residual), on :func:`train_batch` of steps 0..n-1; the port's under
    :class:`ReferenceGemm` and :func:`reference_ce`. With ``carry`` each
    port step starts from the reference's state before it (carried over
    by ``train_state_from_jax``), so that every step is held from one
    state; else the port runs on from its own. Yields after each step
    (step number, the reference's state before the step, after it, its
    metrics, the port's state before the step, after it, its metrics, the
    port's :func:`reduced_rows`)."""
    from repro.optim.adamw import adamw_init as jadamw_init
    from repro.optim.compress import compress_init as jcompress_init
    from repro.train.step import StepConfig as JStepConfig
    from repro.train.step import TrainState as JTrainState
    from repro.train.step import make_train_step as jmake_train_step
    from repro_torch.convert import train_state_from_jax
    from repro_torch.train.step import StepConfig, make_train_step

    s = bf16_pair(arch)
    jlib, lib = libs()
    sc = dict(STEP, microbatches=microbatches, compress_pods=compress)
    jstep = jax.jit(jmake_train_step(s["jcfg"].replace(numerics="interp"),
                                     JStepConfig(**sc), jlib),
                    compiler_options=COMPILER_OPTIONS)
    step = make_train_step(s["cfg"].replace(numerics="interp"),
                           StepConfig(**sc), lib)
    jp = s["jparams"]
    jstate = JTrainState(jp, jadamw_init(jp),
                         jcompress_init(jp) if compress else None)
    state = None
    for i in range(n):
        if carry or state is None:
            state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         s["cfg"], "cpu")
        batch = train_batch(arch, i)
        before, pbefore = jstate, state
        jstate, jm = jstep(jstate, jax_batch(batch), jnp.asarray(i, jnp.int32))
        with reduced_rows(state.params) as sink, ReferenceGemm(), \
                reference_ce():
            state, m = step(state, batch, i)
        yield i + 1, before, jstate, jm, pbefore, state, m, sink


B1, B2 = train_parity.B1, train_parity.B2  # AdamW's moment decays
WEIGHT_DECAY = 0.1  # both packages' ``StepConfig`` default


def aux_order_bound(aux: float, cfg) -> float:
    """How far two float32 summation orders of the MoE aux loss may lie
    apart: each MoE layer's mean router probability per expert sums N =
    :data:`TRAIN_BATCH` * :data:`TRAIN_SEQ` positive terms (two orders
    within 2 (N - 1) 2^-24 of their sum), then E products and the layers'
    sum add a rounding each."""
    n = TRAIN_BATCH * TRAIN_SEQ
    layers = sum(k.ffn == "moe" for *_, k in tf.layer_slots(cfg))
    return (2 * n + cfg.moe.n_experts + 4 + layers) * 2.0 ** -24 * abs(aux)


# parameters the reference's backward reduces in bf16: a bf16 leaf added
# to (a QKV bias) or multiplied into (the SSM's ``d_skip``, once a step
# has written it back in bf16) a bf16 activation by broadcast
REDUCED = ("bq", "bk", "bv", "d_skip")


class _RowsTap(torch.autograd.Function):
    """``t`` expanded to the ``shape`` it is broadcast to (the same sum or
    product as the broadcast); its backward adds sum |cotangent| over the
    broadcast rows, per element of ``t``, and the rows' count to
    ``sink[key]``, and returns what the broadcast's backward returns
    (``sum_to_size``)."""

    @staticmethod
    def forward(ctx, t, shape, sink, key):
        ctx.sink, ctx.key, ctx.shape = sink, key, t.shape
        return t.expand(shape)

    @staticmethod
    def backward(ctx, g):
        mag = g.detach().float().abs().sum_to_size(ctx.shape).reshape(-1)
        acc, n = ctx.sink.get(ctx.key, (0.0, 0))
        ctx.sink[ctx.key] = (acc + mag.numpy(),
                             n + g.numel() // max(mag.numel(), 1))
        return g.sum_to_size(ctx.shape), None, None, None


class _SkipTap(TorchFunctionMode):
    """``x * d_skip[None, None, :, None]`` with ``d_skip`` a layer's leaf
    in ``where`` goes through :class:`_RowsTap`."""

    _muls = {torch.mul, torch.Tensor.mul, torch.Tensor.__mul__,
             torch.Tensor.__rmul__}

    def __init__(self, where: dict, sink: dict):
        super().__init__()
        self.where, self.sink = where, sink

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._muls and len(args) == 2 and not kwargs:
            x, v = args
            key = (self.where.get(v.data_ptr())
                   if isinstance(v, torch.Tensor) and v.dim() == 4 else None)
            if (key is not None and isinstance(x, torch.Tensor)
                    and v.shape[:2] == (1, 1) and v.shape[3] == 1):
                return func(x, _RowsTap.apply(v, x.shape, self.sink, key))
        return func(*args, **kwargs)


@contextlib.contextmanager
def reduced_rows(params: dict):
    """While open, each :data:`REDUCED` leaf of ``params`` meets its
    activation through :class:`_RowsTap` (the QKV biases at
    ``attention.tp_cols``, ``d_skip`` at its product in ``ssd_chunked``);
    yields the sink: (leaf path, layer or None) -> (sum over the rows of
    |cotangent| per element, the rows' count), from the backward passes
    (every microbatch's)."""
    from repro_torch.models import attention as attn

    where = {}
    for name, t in leaves_with_paths(params):
        if name.rsplit("/", 1)[-1] in REDUCED:
            rows = [t] if t.dim() == 1 else list(t.unbind(0))
            for i, r in enumerate(rows):
                where[r.data_ptr()] = (name, None if t.dim() == 1 else i)
    sink: dict = {}
    real = attn.tp_cols

    def tap(t, n, mesh):
        key = where.get(t.data_ptr())
        if key is None or mesh is not None:
            return real(t, n, mesh)
        return _RowsTap.apply(t, (TRAIN_BATCH, TRAIN_SEQ, n), sink, key)

    attn.tp_cols = tap
    try:
        with _SkipTap(where, sink):
            yield sink
    finally:
        attn.tp_cols = real


def reduced_bound(name: str, sink: dict) -> np.ndarray:
    """Per element of a :data:`REDUCED` leaf's gradient (a stacked leaf's
    layers stacked): the reference's own rounding of it. It reduces the
    bf16 cotangent over the N rows in bf16, each of the N - 1 additions
    rounding by at most 2^-8 of a partial sum, so within (N - 1) 2^-8
    sum_i |g_i| of the exact sum; the port sums in float32 and rounds
    once."""
    rows = sorted((-1 if layer is None else layer, v)
                  for (leaf, layer), v in sink.items() if leaf == name)
    assert rows, name
    return np.stack([(n - 1) * 2.0 ** -8 * acc for _, (acc, n) in rows])


def hold_train_gemm(arch: str) -> dict:
    """The bitwise hold: the port's ``loss_and_grads`` at bf16 under
    interp numerics bound to the default library, its forward bf16 x bf16
    products and its CE from XLA (:class:`ReferenceGemm`, a checkpoint's
    recompute included, and :func:`reference_ce`), against the
    reference's ``jax.value_and_grad``. Held: the loss bitwise; the aux
    loss bitwise, or within its mean's summation order
    (:func:`aux_order_bound`); every gradient in its parameter's dtype
    and within 2 bf16 ulps of its leaf's largest |gradient| (the backward
    products are each package's own), a bf16 :data:`REDUCED` leaf within
    that plus :func:`reduced_bound`; a leaf whose reference gradient is
    all zero (the table reads pass none) all zero. Returns each leaf's
    distance in those ulps."""
    cfg = bf16_pair(arch)["cfg"]
    want = ref_train(arch, "interp")
    with reduced_rows(bf16_pair(arch)["params"]) as sink:
        got = port_train(arch, "interp", gemm=True)
    assert_grad_dtypes(got, arch)
    assert got["loss"] == want["loss"]
    if cfg.moe is None:
        assert got["aux"] == want["aux"] == 0
    else:
        assert want["aux"] > 0
        assert abs(got["aux"] - want["aux"]) <= aux_order_bound(
            want["aux"], cfg)
    ulps = gemm_ulps(got, want)
    for name, r in want["grads"].items():
        g, scale = got["grads"][name], float(np.abs(r).max())
        if scale == 0:
            np.testing.assert_array_equal(g, 0.0, err_msg=name)
        elif (name.rsplit("/", 1)[-1] in REDUCED
              and got["dtypes"][name] == torch.bfloat16):
            err = np.abs(g - r).reshape(-1, r.shape[-1])
            bound = 2 * bf16_ulp(scale) + reduced_bound(name, sink)
            assert (err <= bound.reshape(err.shape)).all(), name
        else:
            assert ulps[name] <= 2, (name, ulps[name])
    return ulps


# The one quantity of the ten families' exact holds (routes forced) whose
# port-to-reference distance passes twice the reference's own bf16 error:
# Jamba's second SSD layer's ``a_log``, 1.15 of it at element (0, 0) of the
# first stacked layer, where the port's bf16 error is -5.6e-4 and the
# reference's +4.3e-4 from the float32 gradient. Two bf16 runs whose
# errors fall on either side of the float32 value lie their sum apart, up
# to 3 own, with neither off: it is held by the accuracy form and by
# :func:`assert_independent_errors`.
TWO_SIDED = {("jamba_v0_1_52b", "segments/seg0/1/mixer/a_log")}


def assert_independent_errors(got: np.ndarray, want: np.ndarray,
                              want32: np.ndarray) -> dict:
    """A gradient leaf of :data:`TWO_SIDED`: the port's bf16 error (from
    the float32 run) within twice the reference's largest (the accuracy
    form); where the port lies furthest from the reference, the two
    errors nonzero and of opposite signs, so that the distance is their
    sum; and that distance within 1.5 x twice the reference's own error
    (the most the accuracy form allows). Returns the two errors there."""
    ep, er = got - want32, want - want32
    own = float(np.abs(er).max())
    assert float(np.abs(ep).max()) <= 2 * own
    i = np.unravel_index(np.abs(got - want).argmax(), got.shape)
    assert ep[i] * er[i] < 0, (i, ep[i], er[i])
    assert abs(got[i] - want[i]) <= 3 * own
    return dict(port=float(ep[i]), ref=float(er[i]))


def hold_train_exact(arch: str) -> dict:
    """The port as it runs at bf16 under exact numerics (every MoE layer
    routed as the reference routes it, :func:`port_train_forced`; check
    the flips first, :func:`route_flips`) against the reference's bf16
    and float32 runs on the same bf16-valued weights: the loss, the aux
    loss and every gradient leaf of the port within twice the reference's
    own bf16-versus-float32 distance of the reference's bf16 run
    (:func:`own_ratios` <= 1), but for a :data:`TWO_SIDED` leaf, held by
    :func:`assert_independent_errors`; and every quantity's bf16 error
    within twice the reference's (:func:`accuracy_ratios` <= 1). Returns
    both ratios, the former also for the unforced run of an MoE family
    (``own_unforced``), and the two-sided leaves' errors (``two_sided``)."""
    want, want32 = ref_train(arch, "exact"), ref_train(arch, "exact",
                                                       f32=True)
    moe = bf16_pair(arch)["cfg"].moe is not None
    got = port_train_forced(arch) if moe else port_train(arch, "exact")
    assert_grad_dtypes(got, arch)
    acc = accuracy_ratios(got, want, want32)
    worst = max(acc, key=acc.get)
    assert acc[worst] <= 1, (worst, acc[worst])
    own = own_ratios(got, want, want32)
    out = dict(acc=acc, own=own, two_sided={})
    for k, v in own.items():
        if (arch, k) in TWO_SIDED:
            out["two_sided"][k] = assert_independent_errors(
                got["grads"][k], want["grads"][k], want32["grads"][k])
        else:
            assert v <= 1, (k, v)
    assert len(out["two_sided"]) == sum(a == arch for a, _ in TWO_SIDED)
    if moe:
        out["own_unforced"] = own_ratios(port_train(arch, "exact"), want,
                                         want32)
    return out


def assert_flips_are_ties(arch: str, name: str = "exact") -> list[dict]:
    """:func:`route_flips`: every token whose top-k set flips at a layer
    (the earlier layers' routes forced equal) has a reference gap between
    its k-th and (k+1)-th probability of at most that layer's max |port -
    reference| router probability; a flip past that would be a fault."""
    out = route_flips(arch, name)
    for f in out:
        assert (f["gaps"] <= f["dprob"]).all(), f
    return out


def hold_train_step(arch: str, microbatches: int, n: int = 3, *,
                    carry: bool = True) -> list:
    """``n`` steps of both packages' train step at bf16
    (:func:`train_steps`; with ``carry`` each from the reference's state).
    Per step: ``lr`` equal; the loss bitwise at step 1 (the bitwise hold's
    batch and state), within 2^-14 of itself later (float32 products
    outside the bf16 GEMMs, in another order, meet the interp tables on
    other batches); the aux loss within its summation order; the gradient
    norm within 2^-10 of itself. With g the reference's clipped gradient,
    recovered from its moments, and G per leaf 4 bf16 ulps of its largest
    |g| (two per microbatch gradient, as the bitwise hold; one binade for
    the clip and the microbatch mean; plus :func:`reduced_bound` on a bf16
    :data:`REDUCED` leaf), elementwise: ``mu`` within (1 - b1) G and
    ``nu`` within (1 - b2) G (2 |g| + G), plus b1 and b2 times the
    moments' difference before the step (nought where the states were
    the same); the float32 master, where both states before the step
    agree, within lr :func:`~train_parity.adamw_gap` (g, G) (AdamW's
    update over the gradient's interval: up to 2 lr where g's sign is a
    tie at the first step, else a few float32 roundings), and where they
    differ (a run on its own state after a tie) within that difference
    (and its decay) plus 2 lr :func:`~train_parity.adamw_max` (both
    updates' largest magnitude); each with the master's own rounding. The
    bf16 parameters differ on at most 1% of the elements, each either
    where the masters differ beyond their rounding or, where they agree to
    2 float32 ulps, one bf16 ulp apart with the master within those ulps
    of the boundary between them. Returns per step the count of
    parameters that differ."""
    cfg = bf16_pair(arch)["cfg"]
    return [assert_step(cfg, microbatches, *out) for out in train_steps(
        arch, microbatches, n, carry=carry)]


def assert_step(cfg, microbatches: int, k: int, before, jstate, jm,
                pbefore, state, m, sink) -> int:
    """One step of :func:`hold_train_step` (the arguments after
    ``microbatches`` as :func:`train_steps` yields them); returns the count
    of parameters that differ."""
    lr = float(jm["lr"])
    assert float(m["lr"]) == lr > 0
    loss, jloss = float(m["loss"]), float(jm["loss"])
    if k == 1:
        assert loss == jloss
    assert abs(loss - jloss) <= 2.0 ** -14 * abs(jloss), (k, loss, jloss)
    if cfg.moe is not None:
        assert abs(float(m["aux"]) - float(jm["aux"])) <= aux_order_bound(
            float(jm["aux"]), cfg)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2.0 ** -10)
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    t = int(jstate.opt.step)
    assert int(state.opt.step) == t == int(before.opt.step) + 1
    bf16_leaves = {name for name, x in leaves_with_paths(before.params)
                   if x.dtype == jnp.bfloat16}
    mu0, mu_r, mu_p = (named(o.mu) for o in (before.opt, jstate.opt,
                                              state.opt))
    nu0, nu_r, nu_p = (named(o.nu) for o in (before.opt, jstate.opt,
                                              state.opt))
    w0, w_r, w_p = (named(o.master) for o in (before.opt, jstate.opt,
                                               state.opt))
    mu0_p, nu0_p, w0_p = (named(getattr(pbefore.opt, f))
                          for f in ("mu", "nu", "master"))
    p_r, p_p = named(jstate.params), named(state.params)
    differ = total = 0
    for name in mu_r:
        g = (mu_r[name] - B1 * mu0[name]) / (1 - B1)
        top = float(np.abs(g).max())
        big = 4 * bf16_ulp(top) if top else 0.0
        if name.rsplit("/", 1)[-1] in REDUCED and name in bf16_leaves:
            big = big + clip * reduced_bound(name, sink).reshape(
                g.shape) / microbatches
        dmu0, dnu0, dw0 = (np.abs(a[name] - b[name]) for a, b in (
            (mu0_p, mu0), (nu0_p, nu0), (w0_p, w0)))
        assert (np.abs(mu_p[name] - mu_r[name]) <= (1 - B1) * big
                + B1 * dmu0 + 2.0 ** -23 * np.abs(mu_r[name])).all(), (
                    k, name)
        assert (np.abs(nu_p[name] - nu_r[name])
                <= (1 - B2) * big * (2 * np.abs(g) + big) + B2 * dnu0
                + 2.0 ** -23 * nu_r[name]).all(), (k, name)
        agree = (dmu0 == 0) & (dnu0 == 0) & (dw0 == 0)
        gap = train_parity.adamw_gap(g, big, mu0[name], nu0[name], t)
        bound = np.where(
            agree, lr * (gap + 2.0 ** -20),
            dw0 * (1 + lr * WEIGHT_DECAY) + lr * (
                2 * train_parity.adamw_max(t) + 2.0 ** -20))
        dw = np.abs(w_p[name] - w_r[name])
        assert (dw <= bound + 2.0 ** -22 * np.abs(w_r[name])).all(), (
            k, name, float((dw - bound).max()))
        ne = p_p[name] != p_r[name]
        # agreeing to a rounding, the masters straddle a boundary
        tie = ne & (dw <= 2.0 ** -22 * np.abs(w_r[name]))
        if tie.any():
            lo = np.minimum(p_p[name], p_r[name])[tie]
            hi = np.maximum(p_p[name], p_r[name])[tie]
            assert (hi - lo <= bf16_ulp_array(lo, hi)).all(), (k, name)
            assert (np.abs(w_r[name][tie] - (lo + hi) / 2)
                    <= 2.0 ** -22 * np.abs(w_r[name][tie])).all()
        differ += int(ne.sum())
        total += ne.size
    assert differ <= 0.01 * total, (k, differ, total)
    return differ


def bf16_ulp_array(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Elementwise one bf16 ulp at the larger magnitude of ``lo`` / ``hi``
    (both bf16 values); the spacing across zero counts the smaller
    subnormal step."""
    mag = np.maximum(np.abs(lo), np.abs(hi))
    with np.errstate(divide="ignore"):
        e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return np.where(mag > 0, 2.0 ** (e - 7), 2.0 ** -133)
