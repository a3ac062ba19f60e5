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
"""
from __future__ import annotations

import functools
import types

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
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics

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


class ReferenceGemm(TorchFunctionMode):
    """Inside, a bf16 x bf16 ``matmul`` / ``@`` is XLA's CPU dot of the same
    operands (the reference's accumulation order), rounded to bf16 as
    XLA rounds it; every other call runs as it is. ``calls`` counts the
    products taken."""

    _dot = staticmethod(jax.jit(lambda a, b: a @ b))
    _ops = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in self._ops and len(args) == 2 and not kwargs
                and all(isinstance(t, torch.Tensor)
                        and t.dtype == torch.bfloat16 for t in args)):
            self.calls += 1
            a, b = (jnp.asarray(t.detach().float().numpy(), jnp.bfloat16)
                    for t in args)
            y = np.asarray(self._dot(a, b), np.float32)
            return torch.from_numpy(y).to(torch.bfloat16)
        return func(*args, **(kwargs or {}))


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
