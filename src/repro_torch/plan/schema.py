"""NumericsPlan: per-layer x per-op-site numerics assignment (twin of
``repro/plan/schema.py``, DESIGN.md §16).

A plan maps every decoder layer onto three *op sites* — the attention
softmax path (``exp_neg``/``recip_pos``/``softmax``), the rmsnorm path
(``rmsnorm``/``rsqrt_pos``), and the activation path (``silu``/``gelu``/
``sigmoid``/``softplus``/``tanh``) — and assigns each site a backend
(exact / interp / interp-fused / interp-guarded) plus a *library slot*: the
(lookup_bits, degree, segmentation) point of the per-function Pareto
frontier that site's tables are compiled at. ``rest`` covers every op
outside the layer stack (final norm, encoder, projector, embeddings-side
glue).

Everything here is frozen dataclasses over tuples so a plan — and hence a
``ModelConfig`` carrying one — stays hashable: the serve engine keys its
AOT table on the config, and two engines differing only in plan must not
share programs. The module imports nothing but the standard library
because ``configs.base`` imports it at module load.

Serialization rides the same schema-versioned snapshot envelope as the
BENCH/DSE artifacts (``repro_torch.dse.record``): ``save_plan`` writes
``{"schema", "meta", "tables": {"numerics_plan": {...}}}`` and
``load_plan`` refuses plan payloads newer than :data:`PLAN_SCHEMA`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

PLAN_SCHEMA = 1

SITES = ("softmax", "rmsnorm", "act")

PLAN_BACKENDS = ("exact", "interp", "interp-fused", "interp-guarded")

# which table kinds an op site draws on (the softmax site needs both the
# exponential and the normalization reciprocal; a site's certified error is
# composed over exactly these kinds)
SITE_KINDS = {
    "softmax": ("exp2neg", "recip"),
    "rmsnorm": ("rsqrt",),
    "act": ("gelu", "sigmoid", "silu", "softplus", "tanh"),
}

SEGMENTATIONS = ("uniform", "hier")


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """A library slot choice: where on the per-function frontier the site's
    tables sit. ``None`` fields mean "the Explorer's per-kind default"."""

    lookup_bits: Optional[int] = None
    degree: Optional[int] = None
    segmentation: str = "uniform"

    def __post_init__(self):
        if self.segmentation not in SEGMENTATIONS:
            raise ValueError(f"unknown segmentation {self.segmentation!r}")

    @property
    def key(self) -> str:
        """Canonical slot identity — the library-dict key engines thread."""
        parts = []
        if self.lookup_bits is not None:
            parts.append(f"R{self.lookup_bits}")
        if self.degree is not None:
            parts.append(f"d{self.degree}")
        if self.segmentation != "uniform":
            parts.append(self.segmentation)
        return ".".join(parts) if parts else "default"

    def table_kwargs(self) -> dict[str, Any]:
        kw: dict[str, Any] = {}
        if self.lookup_bits is not None:
            kw["lookup_bits"] = int(self.lookup_bits)
        if self.degree is not None:
            kw["degree"] = int(self.degree)
        return kw

    def to_dict(self) -> dict[str, Any]:
        return {"lookup_bits": self.lookup_bits, "degree": self.degree,
                "segmentation": self.segmentation}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SlotSpec":
        return cls(lookup_bits=d.get("lookup_bits"), degree=d.get("degree"),
                   segmentation=d.get("segmentation", "uniform"))


@dataclasses.dataclass(frozen=True)
class SiteAssign:
    """One op site's (backend, slot) assignment."""

    backend: str = "exact"
    slot: SlotSpec = SlotSpec()

    def __post_init__(self):
        if self.backend not in PLAN_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(choose from {PLAN_BACKENDS})")

    @property
    def interp(self) -> bool:
        return self.backend != "exact"

    def to_dict(self) -> dict[str, Any]:
        return {"backend": self.backend, "slot": self.slot.to_dict()}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SiteAssign":
        return cls(backend=d.get("backend", "exact"),
                   slot=SlotSpec.from_dict(d.get("slot", {})))


@dataclasses.dataclass(frozen=True)
class LayerAssign:
    """The three op-site assignments of one layer (or of ``rest``)."""

    softmax: SiteAssign = SiteAssign()
    rmsnorm: SiteAssign = SiteAssign()
    act: SiteAssign = SiteAssign()

    def site(self, name: str) -> SiteAssign:
        if name not in SITES:
            raise KeyError(name)
        return getattr(self, name)

    @property
    def uniform_backend(self) -> Optional[str]:
        """The single backend name when all three sites agree (slot
        included), else None. The collapsed case binds one raw backend
        instance for the whole layer — the bitwise-identity path."""
        a = (self.softmax, self.rmsnorm, self.act)
        return self.softmax.backend if a[0] == a[1] == a[2] else None

    def with_site(self, name: str, assign: SiteAssign) -> "LayerAssign":
        return dataclasses.replace(self, **{name: assign})

    def to_dict(self) -> dict[str, Any]:
        return {s: self.site(s).to_dict() for s in SITES}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LayerAssign":
        return cls(**{s: SiteAssign.from_dict(d[s]) for s in SITES if s in d})


_EXACT = LayerAssign()


@dataclasses.dataclass(frozen=True)
class NumericsPlan:
    """Per-layer numerics assignment for a whole model."""

    layers: tuple[LayerAssign, ...]
    rest: LayerAssign = _EXACT

    @classmethod
    def uniform(cls, backend: str, n_layers: int,
                slot: SlotSpec = SlotSpec()) -> "NumericsPlan":
        """The degenerate plan: one (backend, slot) everywhere — including
        ``rest`` — which must reproduce the homogeneous engines bitwise."""
        la = LayerAssign(SiteAssign(backend, slot), SiteAssign(backend, slot),
                         SiteAssign(backend, slot))
        return cls(layers=(la,) * int(n_layers), rest=la)

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def layer(self, i: int) -> LayerAssign:
        return self.layers[i]

    def assignments(self) -> Iterable[tuple[str, str, SiteAssign]]:
        """Yields (layer-label, site, assign) over layers then ``rest``."""
        for i, la in enumerate(self.layers):
            for s in SITES:
                yield str(i), s, la.site(s)
        for s in SITES:
            yield "rest", s, self.rest.site(s)

    @property
    def uses_interp(self) -> bool:
        return any(a.interp for _, _, a in self.assignments())

    def slot_keys(self) -> tuple[str, ...]:
        """Distinct slot keys of the non-exact assignments, sorted — the
        set of libraries an engine must compile/thread."""
        return tuple(sorted({a.slot.key for _, _, a in self.assignments()
                             if a.interp}))

    def slots(self) -> dict[str, SlotSpec]:
        return {a.slot.key: a.slot for _, _, a in self.assignments()
                if a.interp}

    def layers_using_slot(self, key: str) -> tuple:
        """Layer labels whose live (non-exact) sites read slot ``key`` —
        int indices, plus ``"rest"`` when the out-of-stack ops do."""
        hit = set()
        for i, la in enumerate(self.layers):
            for s in SITES:
                a = la.site(s)
                if a.interp and a.slot.key == key:
                    hit.add(i)
        labels = tuple(sorted(hit))
        if any(a.interp and a.slot.key == key
               for a in (self.rest.site(s) for s in SITES)):
            labels = labels + ("rest",)
        return labels

    def map_assignments(self, fn) -> "NumericsPlan":
        """New plan with ``fn(layer_label, site, assign) -> assign`` applied
        everywhere (``layer_label`` is the int index or ``"rest"``)."""
        layers = []
        for i, la in enumerate(self.layers):
            layers.append(LayerAssign(
                **{s: fn(i, s, la.site(s)) for s in SITES}))
        rest = LayerAssign(**{s: fn("rest", s, self.rest.site(s))
                              for s in SITES})
        return NumericsPlan(layers=tuple(layers), rest=rest)

    def degrade_serial(self) -> "NumericsPlan":
        """The plan-level fused -> serial rung: every interp site drops to
        the guarded per-table datapath; exact sites stay exact."""
        def down(_i, _s, a):
            if a.backend in ("interp", "interp-fused"):
                return dataclasses.replace(a, backend="interp-guarded")
            return a
        return self.map_assignments(down)

    def degrade_exact(self) -> "NumericsPlan":
        return self.map_assignments(
            lambda _i, _s, a: SiteAssign("exact", a.slot))

    def degrade_layers(self, layer_ids: Iterable[int],
                       slot_keys: Iterable[str]) -> "NumericsPlan":
        """Downgrade only the named layers' sites that draw on the named
        slots to exact — the per-layer degradation rung: a poisoned slot
        library takes down exactly the layers reading it."""
        ids = {i if i == "rest" else int(i) for i in layer_ids}
        keys = set(slot_keys)

        def down(i, _s, a):
            if i in ids and a.interp and a.slot.key in keys:
                return SiteAssign("exact", a.slot)
            return a
        return self.map_assignments(down)

    def to_dict(self) -> dict[str, Any]:
        return {"plan_schema": PLAN_SCHEMA,
                "layers": [la.to_dict() for la in self.layers],
                "rest": self.rest.to_dict()}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "NumericsPlan":
        v = d.get("plan_schema", 1)
        if v > PLAN_SCHEMA:
            raise ValueError(f"plan schema {v} is newer than this code "
                             f"({PLAN_SCHEMA})")
        return cls(layers=tuple(LayerAssign.from_dict(x)
                                for x in d["layers"]),
                   rest=LayerAssign.from_dict(d.get("rest", {})))


def save_plan(path, plan: NumericsPlan, *, seed: int | None = None,
              meta_extra: dict[str, Any] | None = None) -> None:
    """Emit a plan through the schema-versioned snapshot envelope."""
    from repro_torch.dse.record import update_snapshot

    update_snapshot(path, {"numerics_plan": plan.to_dict()}, seed=seed,
                    meta_extra=meta_extra)


def load_plan(path) -> NumericsPlan:
    from repro_torch.dse.record import read_snapshot

    tables = read_snapshot(path)
    if "numerics_plan" not in tables:
        raise ValueError(f"{path}: no 'numerics_plan' table in snapshot")
    return NumericsPlan.from_dict(tables["numerics_plan"])


def plan_for(cfg, backend: str | None = None,
             slot: SlotSpec = SlotSpec()) -> NumericsPlan:
    """Uniform plan matching a model config (``backend`` defaults to
    ``cfg.numerics``)."""
    return NumericsPlan.uniform(backend or cfg.numerics, cfg.n_layers,
                                slot=slot)
