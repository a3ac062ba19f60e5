"""Resolve a :class:`NumericsPlan` into executable backend objects (twin of
``repro/plan/numerics.py``).

The model stack consumes one ``numerics`` object per layer: the
transformer's layer loop asks a :class:`PlanNumerics` ``for_layer(i)`` and
gets either a raw homogeneous backend (when all three op sites of the layer
agree: the bitwise-identity path) or a :class:`SiteNumerics` that routes
each op family to its site's backend. ``PlanNumerics`` itself answers every
op by delegating to the ``rest`` assignment, so call sites outside the
layer stack (the final norm) need no plan awareness.

Backends and per-layer wrappers are interned per distinct assignment, so
two layers with equal assignments share one instance (and, on the card,
one library's kernel operands).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve
from repro_torch.plan.schema import SITES, LayerAssign, NumericsPlan, SiteAssign

# op name -> op site; everything the model stack calls on a numerics object
SITE_OF_OP = {
    "exp_neg": "softmax", "recip_pos": "softmax", "softmax": "softmax",
    "rmsnorm": "rmsnorm", "rsqrt_pos": "rmsnorm",
    "silu": "act", "gelu": "act", "sigmoid": "act", "softplus": "act",
    "tanh": "act",
}


def _resolve_backend(assign: SiteAssign, libraries, plain: bool = False):
    """Instantiate the backend of one site assignment. ``libraries`` is a
    dict keyed by slot key, a single library applied to every slot, or
    None (per-op lazy table resolution through the default session).
    ``plain=True`` (port only) resolves ``interp-fused`` to
    :class:`PlainFusedNumerics`, the kernels' plain versions on any device:
    the oracle a card run holds a plan engine against."""
    from repro_torch.numerics.ops import (ExactNumerics, FusedInterpNumerics,
                                          InterpNumerics, PlainFusedNumerics)

    if assign.backend == "exact":
        return ExactNumerics()
    if isinstance(libraries, dict):
        lib = libraries.get(assign.slot.key)
    else:
        lib = libraries
    if assign.backend == "interp":
        return InterpNumerics(lib)
    if assign.backend == "interp-guarded":
        from repro_torch.numerics.guard import GuardedNumerics

        return GuardedNumerics(InterpNumerics(lib))
    if assign.backend == "interp-fused":
        if lib is None:
            raise ValueError(
                f"plan site {assign} is interp-fused but no library is "
                f"bound for slot {assign.slot.key!r}; compile one with "
                f"compile_plan_libraries()")
        return (PlainFusedNumerics if plain else FusedInterpNumerics)(lib)
    raise KeyError(assign.backend)


class SiteNumerics:
    """Per-op-site router: one layer's three backends behind the uniform
    numerics interface the model stack already speaks."""

    name = "plan-site"

    def __init__(self, softmax_b, rmsnorm_b, act_b):
        self._softmax = softmax_b
        self._rmsnorm = rmsnorm_b
        self._act = act_b

    @property
    def library(self):
        return self._softmax.library

    @property
    def softmax_backend(self):
        """The softmax site's backend: it decides the attention path
        (``models.attention.decode_reads_host``)."""
        return self._softmax

    # softmax site
    def exp_neg(self, x):
        return self._softmax.exp_neg(x)

    def recip_pos(self, x):
        return self._softmax.recip_pos(x)

    def softmax(self, x, axis: int = -1):
        return self._softmax.softmax(x, axis=axis)

    def fused_attention(self, q, k, v, q_pos, kv_pos, *, causal, window,
                        scale):
        fa = getattr(self._softmax, "fused_attention", None)
        if fa is None:
            return None  # caller falls back to the chunked glue path
        return fa(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                  scale=scale)

    # rmsnorm site
    def rmsnorm(self, x, gamma, eps: float = 1e-6):
        return self._rmsnorm.rmsnorm(x, gamma, eps)

    def rsqrt_pos(self, x):
        return self._rmsnorm.rsqrt_pos(x)

    # activation site
    def silu(self, x):
        return self._act.silu(x)

    def gelu(self, x):
        return self._act.gelu(x)

    def sigmoid(self, x):
        return self._act.sigmoid(x)

    def softplus(self, x):
        return self._act.softplus(x)

    def tanh(self, x):
        return self._act.tanh(x)


class PlanNumerics:
    """A resolved plan: per-layer numerics plus the ``rest`` delegate."""

    name = "plan"

    def __init__(self, plan: NumericsPlan, libraries=None,
                 plain: bool = False):
        self.plan = plan
        self.libraries = libraries
        self.plain = bool(plain)
        self._backends: dict[SiteAssign, object] = {}
        self._by_layer: dict[LayerAssign, object] = {}
        self._layers = tuple(self._layer_numerics(la) for la in plan.layers)
        self._rest = self._layer_numerics(plan.rest)

    def _backend(self, assign: SiteAssign):
        b = self._backends.get(assign)
        if b is None:
            b = _resolve_backend(assign, self.libraries, self.plain)
            self._backends[assign] = b
        return b

    def _layer_numerics(self, la: LayerAssign):
        n = self._by_layer.get(la)
        if n is None:
            if la.uniform_backend is not None:
                # collapsed case: the layer's three sites share one backend
                # instance, the object the homogeneous path builds
                n = self._backend(la.softmax)
            else:
                n = SiteNumerics(*(self._backend(la.site(s)) for s in SITES))
            self._by_layer[la] = n
        return n

    @property
    def n_layers(self) -> int:
        return len(self._layers)

    def for_layer(self, i: int):
        return self._layers[i]

    @property
    def library(self):
        return self.libraries

    def __getattr__(self, attr):
        # ops outside the layer stack (the final norm) evaluate under the
        # ``rest`` assignment
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self._rest, attr)


def _session(device: torch.device):
    """An Explorer with the default session's configuration, packing on
    ``device`` (its tables come through the same disk cache)."""
    from repro_torch.api import Explorer, default_explorer

    return Explorer(dataclasses.replace(default_explorer().config,
                                        device=str(device)))


def compile_plan_libraries(plan: NumericsPlan, explorer=None,
                           device: str | torch.device = "cuda"
                           ) -> Optional[dict]:
    """One compiled :class:`InterpLibrary` per distinct slot of the plan,
    on ``device``.

    Every slot library carries the full default kind manifest (not just the
    site's kinds): a collapsed uniform layer binds a single backend serving
    all three sites, and the homogeneous engines it must match bitwise
    serve the full manifest too. Without an ``explorer`` the ``default``
    slot is :meth:`InterpLibrary.default_library` (the bytes the default
    session's ``compile()`` makes, from the vendored tables) and the other
    slots compile through one session like the default one on
    ``device``.
    """
    slots = plan.slots()
    if not slots:
        return None
    from repro_torch.api.library import InterpLibrary

    dev = resolve(device)
    out = {}
    ex = explorer
    for key, slot in sorted(slots.items()):
        kw = slot.table_kwargs()
        if explorer is None and not kw and slot.segmentation == "uniform":
            out[key] = InterpLibrary.default_library(dev)
            continue
        if ex is None:
            ex = _session(dev)
        if slot.segmentation == "hier":
            lib = ex.compile_segmented(**kw)
        else:
            lib = ex.compile(**kw)
        if lib.device != dev:
            lib = InterpLibrary(lib.coeffs.to(dev), lib.metas).seal(
                lib.sealed_sha)
        out[key] = lib
    return out


def plan_numerics(plan: NumericsPlan, libraries=None, explorer=None,
                  device: str | torch.device = "cuda",
                  plain: bool = False) -> PlanNumerics:
    """Resolve a plan, compiling slot libraries on ``device`` when none are
    supplied and the plan has fused sites (serial interp sites can stay
    lazy)."""
    if libraries is None and any(
            a.backend == "interp-fused" for _, _, a in plan.assignments()):
        libraries = compile_plan_libraries(plan, explorer, device)
    return PlanNumerics(plan, libraries, plain=plain)
