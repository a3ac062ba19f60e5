"""Frozen exploration configuration + the per-kind default table (twin of
``repro/api/config.py``).

``ExploreConfig`` replaces the per-function keyword soup (``impl`` /
``degree`` / ``processes`` / ``lookup_bits`` threaded through every call in
the seed) with one frozen, hashable session configuration. ``DEFAULTS`` is
the single source of truth for the ML-numerics kinds' widths and lookup
bits — ``repro_torch.numerics.registry`` re-exports it instead of carrying its own
copy (DESIGN.md §7.5).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib

from repro_torch.core.funcspec import FunctionSpec, get_spec

# Single source of truth for the divided-difference search implementation
# (core.searches.IMPLS) and the region-engine backend. Core modules resolve
# their ``impl=None`` / ``engine=None`` defaults against these lazily, so the
# whole pipeline is retuned from one place.
DEFAULT_IMPL = "hull"
DEFAULT_ENGINE = "batched"

# engine -> how the per-region §II work (envelopes, Eqns 9-10 feasibility,
# a-intervals, truncation re-checks) is dispatched:
#   batched  one numpy array program over stacked (regions, N) arrays
#   pallas   the float32 device program: one launch of the CUDA envelope
#            kernel + on-device parity merge / a-interval reduction on
#            ``ExploreConfig.device`` (the name is the reference's, which
#            configuration and DSE records carry; "cpu" runs the kernels'
#            plain versions)
#   pooled   the seed's per-region scalar dispatch through RegionPool —
#            kept as fallback and as the equivalence oracle in tests
ENGINES = ("batched", "pallas", "pooled")

# Envelope-cache LRU cap (entries, one per (spec, R, engine)); None = unbounded.
DEFAULT_ENVELOPE_CACHE = 64

# Fleet engine default: stack every (kind, spec, R) probe a manifest needs
# into one array program (core.fleet) instead of F x R serial probes. Only
# the batched engine routes through it (the fleet is bit-identical to that
# engine; pooled/pallas sessions keep their per-spec dispatch).
# DEFAULT_ENGINE stays the exact float64 engine: the device engines are
# float32 by contract (DESIGN.md §9), so making one of them the default
# would change which designs come out.
DEFAULT_FLEET = True

# kind -> (in_bits, spec kwargs, lookup_bits). Widths are chosen so every
# coefficient fits int32 and the one-hot LUT contraction is exact in fp32.
DEFAULTS: dict[str, tuple[int, dict, int]] = {
    "exp2neg": (12, {"out_bits": 13}, 6),
    "recip": (12, {}, 6),
    "rsqrt": (12, {"out_bits": 13}, 6),
    "silu": (12, {"out_bits": 12}, 6),
    "sigmoid": (12, {"out_bits": 12}, 6),
    "softplus": (12, {"out_bits": 12}, 6),
    "gelu": (12, {"out_bits": 12}, 6),
    "tanh": (12, {"out_bits": 12}, 6),
    "log2": (12, {"out_bits": 13}, 6),
    "exp2": (12, {"out_bits": 12}, 6),
}


def default_cache_dir() -> pathlib.Path:
    return pathlib.Path(
        os.environ.get(
            "REPRO_TABLE_CACHE",
            pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "tables",
        )
    )


def spec_for(kind: str, bits: int | None = None, **kw) -> FunctionSpec:
    """Build a FunctionSpec for ``kind`` with the registry defaults merged in."""
    d_bits, d_kw, _ = DEFAULTS[kind]
    merged = dict(d_kw)
    merged.update(kw)
    return get_spec(kind, bits if bits is not None else d_bits, **merged)


@dataclasses.dataclass(frozen=True)
class ExploreConfig:
    """Session-wide exploration parameters (all optional, all overridable
    per-call on :class:`repro_torch.api.Explorer` methods).

    Attributes:
      kind/bits/out_bits/ulp: the function spec, resolved through
        :data:`DEFAULTS` (``spec()`` builds the FunctionSpec).
      degree: force degree 1/2; None = the target policy's lin-vs-quad rule.
      lookup_bits: fixed R; None = sweep ``[r_lo, r_hi]`` (a per-call
        ``r_lo``/``r_hi`` on ``explore()`` overrides a pinned height).
      r_lo/r_hi: sweep range; None = minimum feasible R and ``r_lo + 6``.
      impl: divided-difference search implementation (core.searches.IMPLS);
        only exercised by the ``pooled`` engine — the batched engines carry
        their own (value-identical) searches.
      engine: region-engine backend, one of :data:`ENGINES`.
      fleet: route ``compile()`` / ``min_regions_many`` / sweep envelope
        priming through the fleet engine (``core.fleet``): every (kind,
        spec, R) probe of a manifest stacked into one array program,
        bit-identical to the serial batched path (which remains the
        equivalence oracle). Ignored unless ``engine == "batched"``.
      mesh: device count to shard the fleet's §II front half over (capped
        at the visible card count; the port runs the fleet kernel as one
        program on ``device``). ``None``/1 keeps the exact single-host
        numpy program; > 1 switches that front half to float32 device
        arithmetic — same contract as ``engine="pallas"``: a marginal
        feasibility verdict can cost a retry, never an unsound artifact.
      envelope_cache: LRU cap on cached (spec, R) RegionSpace lists; None
        disables eviction (evictions are counted in ``envelope_stats``).
      k_max: precision-slack search cap of decision step 1; None defers to
        the target policy's cap.
      workers: RegionPool process count (None/1 = in-process); only the
        ``pooled`` engine forks.
      cache_dir: table persistence directory; None = $REPRO_TABLE_CACHE or
        ``artifacts/tables``.
      device: torch device of the device paths (``engine="pallas"`` and
        the fleet when ``mesh > 1``) and of the libraries ``compile()``
        packs, resolved through :func:`repro_torch.device.resolve` when one
        of them runs, so asking for ``"cuda"`` without a card raises;
        ``"cpu"`` runs the kernels' plain versions. The exact engines'
        search never reads it.
    """

    kind: str = "recip"
    bits: int | None = None
    out_bits: int | None = None
    ulp: float = 1.0
    degree: int | None = None
    lookup_bits: int | None = None
    r_lo: int | None = None
    r_hi: int | None = None
    impl: str = DEFAULT_IMPL
    engine: str = DEFAULT_ENGINE
    fleet: bool = DEFAULT_FLEET
    mesh: int | None = None
    envelope_cache: int | None = DEFAULT_ENVELOPE_CACHE
    k_max: int | None = None
    workers: int | None = None
    cache_dir: str | None = None
    device: str = "cuda"

    def spec(self) -> FunctionSpec:
        kw: dict = {"ulp": self.ulp}
        if self.out_bits is not None:
            kw["out_bits"] = self.out_bits
        if self.bits is None:
            # default width: the ML-table defaults (out_bits etc.) apply
            return spec_for(self.kind, None, **kw)
        # explicit width: DEFAULTS kwargs are tuned for the default width
        # only — use the maker's own defaults, as the seed's get_spec did
        return get_spec(self.kind, self.bits, **kw)

    def resolved_cache_dir(self) -> pathlib.Path:
        if self.cache_dir is not None:
            return pathlib.Path(self.cache_dir)
        return default_cache_dir()
