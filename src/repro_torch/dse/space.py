"""Search spaces: declarative grids over :class:`TrialParams` (twin of
``repro/dse/space.py``).

A ``SearchSpace`` is the cross product of per-axis value tuples, enumerated
in a deterministic order (axis order below, values in the given order) —
the enumeration order is part of the resume contract: a resumed study walks
the same sequence and skips journaled keys, so "zero re-executed trials"
is checkable by counter.

Two presets ship: :func:`smoke_space` (the CI dse-smoke study — small
enough to run twice per CI job) and :func:`default_space` (the committed-
frontier study over the whole table manifest).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterator

from repro_torch.api.config import DEFAULTS
from repro_torch.dse.trial import TrialParams

SPACE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Axis grids; every field mirrors a :class:`TrialParams` field."""

    kinds: tuple[str, ...] = ("recip",)
    lookup_bits: tuple[int, ...] = (5, 6, 7)
    targets: tuple[str, ...] = ("asic",)
    bits: tuple[int | None, ...] = (None,)
    out_bits: tuple[int | None, ...] = (None,)
    ulps: tuple[float, ...] = (1.0,)
    degrees: tuple[int | None, ...] = (None,)
    engines: tuple[str, ...] = ("batched",)
    fused: tuple[bool, ...] = (True,)
    horizons: tuple[int, ...] = (8,)
    batches: tuple[int, ...] = (4,)
    arch: str = "yi_6b"
    segmentations: tuple[str, ...] = ("uniform",)

    def __len__(self) -> int:
        n = 1
        for axis in (self.kinds, self.lookup_bits, self.targets, self.bits,
                     self.out_bits, self.ulps, self.degrees, self.engines,
                     self.fused, self.horizons, self.batches,
                     self.segmentations):
            n *= len(axis)
        return n

    def trials(self) -> Iterator[TrialParams]:
        """Deterministic enumeration (itertools.product in axis order)."""
        for (kind, r, target, bits, out_bits, ulp, degree, engine, fused,
             horizon, batch, segmentation) in itertools.product(
                self.kinds, self.lookup_bits, self.targets, self.bits,
                self.out_bits, self.ulps, self.degrees, self.engines,
                self.fused, self.horizons, self.batches, self.segmentations):
            yield TrialParams(kind=kind, lookup_bits=r, target=target,
                              bits=bits, out_bits=out_bits, ulp=ulp,
                              degree=degree, engine=engine, fused=fused,
                              horizon=horizon, batch=batch, arch=self.arch,
                              segmentation=segmentation)

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["schema"] = SPACE_SCHEMA
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SearchSpace":
        d = dict(d)
        schema = d.pop("schema", SPACE_SCHEMA)
        if schema != SPACE_SCHEMA:
            raise ValueError(f"search-space schema {schema!r} != {SPACE_SCHEMA}")
        tuple_fields = {f.name for f in dataclasses.fields(cls)
                        if f.name != "arch"}
        return cls(**{k: tuple(v) if k in tuple_fields else v
                      for k, v in d.items()})


def smoke_space() -> SearchSpace:
    """The CI study: 2 kinds x 2 heights x 2 targets x fused/serial = 16
    trials, 2 distinct serve-probe keys. Small enough to run fresh + resumed
    in one CI job, big enough that every objective axis varies."""
    return SearchSpace(kinds=("recip", "exp2neg"), lookup_bits=(5, 6),
                       targets=("asic", "pallas-tpu"), fused=(False, True),
                       horizons=(4,), batches=(2,), arch="yi_6b")


def default_space() -> SearchSpace:
    """The committed-frontier study: every library kind, the useful height
    band around the registry defaults, all built-in targets, both serve
    paths and two dispatch shapes."""
    return SearchSpace(kinds=tuple(sorted(DEFAULTS)), lookup_bits=(4, 5, 6, 7, 8),
                       targets=("asic", "fpga-lut", "pallas-tpu"),
                       fused=(False, True), horizons=(8,), batches=(2, 8),
                       arch="yi_6b")


def segment_space() -> SearchSpace:
    """The study-8 increment: the four activation/transcendental kinds the
    segment subsystem most benefits, both layouts per point, every target.
    A deterministic chunk of the full product — small enough to regenerate
    from scratch, big enough that uniform and hier compete on every
    frontier group."""
    return SearchSpace(kinds=("exp2neg", "recip", "sigmoid", "tanh"),
                       lookup_bits=(5, 6),
                       targets=("asic", "fpga-lut", "pallas-tpu"),
                       fused=(True,), horizons=(8,), batches=(2,),
                       arch="yi_6b", segmentations=("uniform", "hier"))


PRESETS = {"smoke": smoke_space, "default": default_space,
           "segment": segment_space}
