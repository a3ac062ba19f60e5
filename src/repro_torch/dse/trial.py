"""Trial schema: one full-stack configuration and its journaled verdict
(twin of ``repro/dse/trial.py``; keys and records are the reference's
bytes, so either package's journal replays in the other).

``TrialParams`` is the unit the DSE layer searches over — everything from
the table's function spec down to the serving engine's dispatch shape. It
is frozen/hashable (usable as a dict key), has a canonical string ``key``
(the journal's dedup key: a resumed study replays a record instead of
re-executing iff the keys match), and round-trips through JSON.

``TrialRecord`` is what the journal stores per trial. Metrics are split by
determinism: ``metrics`` holds only values that are bit-reproducible given
the same code (exact integer area/delay/margin proxies, counter-modeled
throughput) — the frontier artifact is built from these, which is what
makes a killed-and-resumed study's frontier byte-identical to an
uninterrupted run's. Wall-clock noise lives in ``timing`` and never
reaches the frontier.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.api.config import DEFAULTS, spec_for
from repro_torch.core.funcspec import FunctionSpec, get_spec

TRIAL_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class TrialParams:
    """One point of the full-stack design space.

    Table axes: ``kind``/``bits``/``out_bits``/``ulp`` (the FunctionSpec),
    ``lookup_bits`` (R), ``degree`` (None = target policy's rule),
    ``target`` (registered Target name), ``engine`` (region backend).
    Serving axes: ``fused`` (one-dispatch tick vs serial oracle),
    ``horizon`` (decode steps per fused dispatch), ``batch`` (slot count),
    ``arch`` (config-zoo architecture the serve probe decodes with).
    ``segmentation`` selects the table layout: ``"uniform"`` (the paper's
    2^R equal regions) or ``"hier"`` (repro_torch.segment's greedy dyadic tree,
    with ``lookup_bits`` as the depth cap).
    """

    kind: str
    lookup_bits: int
    target: str = "asic"
    bits: int | None = None
    out_bits: int | None = None
    ulp: float = 1.0
    degree: int | None = None
    engine: str = "batched"
    fused: bool = True
    horizon: int = 8
    batch: int = 4
    arch: str = "yi_6b"
    segmentation: str = "uniform"

    def spec(self) -> FunctionSpec:
        """Resolve the FunctionSpec exactly as ``ExploreConfig.spec`` does:
        default width inherits the registry's per-kind kwargs; an explicit
        width uses the maker's own defaults."""
        kw: dict = {"ulp": self.ulp}
        if self.out_bits is not None:
            kw["out_bits"] = self.out_bits
        if self.bits is None:
            return spec_for(self.kind, None, **kw)
        return get_spec(self.kind, self.bits, **kw)

    @property
    def resolved_bits(self) -> int:
        return self.bits if self.bits is not None else DEFAULTS[self.kind][0]

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrialParams":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown TrialParams fields {sorted(unknown)} "
                             f"(newer trial schema?)")
        return cls(**d)

    @property
    def key(self) -> str:
        """Canonical journal key: compact JSON with sorted field names, so
        the key is stable across processes and dataclass field reordering."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))


@dataclasses.dataclass
class TrialRecord:
    """One journaled verdict: parameters + deterministic metrics.

    ``status`` is ``"ok"`` or ``"infeasible"`` (no piecewise polynomial of
    the requested degree exists at this R under this target — a real
    answer worth journaling: resuming must not retry it). ``objectives``
    is the minimized vector the frontier is computed over (None when
    infeasible); ``timing`` holds wall-clock observations excluded from
    the frontier.
    """

    params: TrialParams
    status: str
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    objectives: list[float] | None = None
    timing: dict[str, float] = dataclasses.field(default_factory=dict)
    schema: int = TRIAL_SCHEMA

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema": self.schema,
            "key": self.params.key,
            "params": self.params.to_dict(),
            "status": self.status,
            "metrics": self.metrics,
            "objectives": self.objectives,
            "timing": self.timing,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrialRecord":
        schema = d.get("schema")
        if schema != TRIAL_SCHEMA:
            raise ValueError(f"trial record schema {schema!r} != "
                             f"{TRIAL_SCHEMA} (migrate the study dir)")
        return cls(params=TrialParams.from_dict(d["params"]),
                   status=d["status"], metrics=dict(d.get("metrics") or {}),
                   objectives=(None if d.get("objectives") is None
                               else [float(x) for x in d["objectives"]]),
                   timing=dict(d.get("timing") or {}), schema=schema)
