"""The Explorer session: one object that owns the pool, the envelope cache
and the table persistence layer.

Pain points of the seed's API that this replaces:

  * ``run_decision`` forked a fresh process pool per call — the session owns
    one ``RegionPool`` for its whole lifetime.
  * ``RegionSpace`` envelopes (§II Eqns 9-10) were recomputed per call even
    though they are target-independent — the session computes them at most
    once per (spec, R) and every target / k-value / degree reuses them
    (``envelope_stats`` exposes the compute/hit counters).
  * ``numerics/registry.py`` kept its own disk+memory cache — that cache is
    now the Explorer's persistence layer (``get_table``).

The per-region §II work routes through the batched region engine by
default (``ExploreConfig.engine``): envelopes, feasibility and
the decision-procedure truncation re-checks run as one array program over
all ``2^R`` regions (``core.batched`` / the ``kernels.dspace`` Pallas
backend), the envelope cache is LRU-bounded, and ``min_regions`` exploits
feasibility monotonicity in R (exponential descent + binary search)
instead of linearly scanning from the most expensive probe. DESIGN.md §9.

Typical use::

    with Explorer(ExploreConfig(kind="recip", bits=12)) as ex:
        asic = ex.explore(target="asic").best
        tpu = ex.explore(target="pallas-tpu").best   # same envelopes, re-decided

See DESIGN.md §6 for the architecture.

Twin of ``repro/api/explorer.py``. The port's device paths
(``engine="pallas"``, and the fleet when ``config.mesh > 1``) run the CUDA
envelope kernels on ``config.device``; ``compile()`` packs its library on
that device too, and so does ``compile_segmented``, whose segmenter runs
the same engines on the same device.
"""
from __future__ import annotations

import collections
import hashlib
import json
import re
import threading
import time

from repro_torch.api.config import DEFAULTS, ENGINES, ExploreConfig, spec_for
from repro_torch.api.library import DEFAULT_LIBRARY_KINDS, InterpLibrary
from repro_torch.api.result import DesignSpaceResult, ExploreEntry
from repro_torch.api.target import Target, get_target
from repro_torch.core import batched, fleet
from repro_torch.core.decision import _run_decision_pooled
from repro_torch.core.designspace import RegionSpace, compute_spaces
from repro_torch.core.funcspec import ACT_HI, ACT_LO, FunctionSpec
from repro_torch.core.pmap import RegionPool
from repro_torch.core.table import TableDesign


class _MinRSearch:
    """State machine of the min-R search (exponential descent from the cheap
    end + binary bracket), factored out of :meth:`Explorer.min_regions` so
    the fleet path can lockstep many searches: each round collects one
    pending (spec, R) probe per live search and answers the whole frontier
    as one stacked array program. Probe sequences — and therefore results
    and cache traffic — are identical to the serial search.
    """

    _WORK_CAP = 1 << 26  # element-work floor where stepping turns costly

    def __init__(self, spec: FunctionSpec, r_max: int | None = None):
        self.spec = spec
        # R > in_bits doesn't exist; a larger r_max must behave like
        # "unbounded", not crash
        self.r_max = spec.in_bits if r_max is None else min(r_max, spec.in_bits)
        self.result: int | None = None
        self.done = self.r_max < 0
        self.hi = self.r_max  # known feasible once init passes
        self.lo = -1  # known infeasible
        self.step = 1
        self.phase = "init"

    def _probe_work(self, r: int) -> int:
        return 4 ** self.spec.in_bits >> max(r, 0)  # ~ 2^R regions x N^2

    def next_probe(self) -> int | None:
        if self.done:
            return None
        if self.phase == "init":
            return self.r_max
        if self.phase == "gallop":
            return max(self.hi - self.step, self.lo + 1)
        return (self.lo + self.hi) // 2  # binary

    def _settle(self) -> None:
        if self.hi - self.lo <= 1:
            self.done = True
            self.result = self.hi

    def feed(self, ok: bool) -> None:
        """Consume the verdict for the probe ``next_probe()`` returned."""
        if self.phase == "init":
            if not ok:  # monotone: nothing below r_max can work either
                self.done = True
                return
            self.phase = "gallop"
            self._settle()
            return
        if self.phase == "gallop":
            if ok:
                self.hi = max(self.hi - self.step, self.lo + 1)
                nxt = max(self.hi - 2 * self.step, self.lo + 1)
                self.step = (2 * self.step
                             if self._probe_work(nxt) <= self._WORK_CAP else 1)
            else:
                self.lo = max(self.hi - self.step, self.lo + 1)
                self.phase = "binary"
            self._settle()
            return
        mid = (self.lo + self.hi) // 2
        if ok:
            self.hi = mid
        else:
            self.lo = mid
        self._settle()


class Explorer:
    """A design-space exploration session.

    Cheap to construct; the worker pool (when ``config.workers > 1``) starts
    lazily on first use and is released by ``close()`` / context exit. All
    caches are per-session except the table disk cache, which is shared
    through ``config.cache_dir``. Table fetches, the envelope cache and the
    pool lifecycle are lock-guarded, so concurrent threads can share one
    session (envelope computation serializes; decision runs don't).
    """

    def __init__(self, config: ExploreConfig | None = None,
                 *, target: str | Target = "asic"):
        self.config = config or ExploreConfig()
        if self.config.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.config.engine!r}; "
                             f"expected one of {ENGINES}")
        self.default_target = target
        self._pool: RegionPool | None = None
        self._spaces: collections.OrderedDict[tuple, list[RegionSpace]] = \
            collections.OrderedDict()
        self._space_computes = 0
        self._space_hits = 0
        self._space_evictions = 0
        self._feasible: collections.OrderedDict[tuple, bool] = \
            collections.OrderedDict()
        self._feas_computes = 0
        self._feas_hits = 0
        self._feas_evictions = 0
        self._bounds: dict[tuple, tuple] = {}  # spec value-key -> (lo, hi)
        self._spec_keys: dict[int, tuple] = {}
        self._spec_refs: dict[int, FunctionSpec] = {}
        self._tables: dict[str, TableDesign] = {}
        self._lock = threading.Lock()  # table cache
        # envelope cache / pool lifecycle / spec-key memo; RLock because
        # envelopes() -> _get_pool() nests (lock order: _lock before _l)
        self._state_lock = threading.RLock()

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "Explorer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        with self._state_lock:
            if self._pool is not None:
                self._pool.__exit__()
                self._pool = None

    def _get_pool(self) -> RegionPool:
        with self._state_lock:
            if self._pool is None:
                self._pool = RegionPool(self.config.workers)
                self._pool.__enter__()
            return self._pool

    # -- envelope cache ----------------------------------------------------
    @property
    def envelope_stats(self) -> dict[str, int]:
        """{'computed': n, 'hits': m, 'evictions': e} — asserts the
        once-per-(spec, R) contract and the LRU bound in tests."""
        return {"computed": self._space_computes, "hits": self._space_hits,
                "evictions": self._space_evictions}

    _FEAS_CACHE_CAP = 4096  # boolean feasibility verdicts kept (LRU)

    @property
    def feasible_stats(self) -> dict[str, int]:
        """{'computed', 'hits', 'evictions'} of the boolean feasibility-
        verdict LRU (min-R probes; shared with the fleet engine's bulk
        probes) — same contract as ``envelope_stats``."""
        return {"computed": self._feas_computes, "hits": self._feas_hits,
                "evictions": self._feas_evictions}

    def _feasible_get(self, fkey: tuple) -> bool | None:
        """LRU lookup + hit accounting; call with _state_lock held."""
        ok = self._feasible.get(fkey)
        if ok is not None:
            self._feasible.move_to_end(fkey)
            self._feas_hits += 1
        return ok

    def _feasible_put(self, fkey: tuple, ok: bool) -> None:
        """LRU insert + eviction accounting; call with _state_lock held."""
        self._feasible[fkey] = ok
        self._feas_computes += 1
        while len(self._feasible) > self._FEAS_CACHE_CAP:
            self._feasible.popitem(last=False)
            self._feas_evictions += 1

    _SPEC_MEMO_CAP = 1024  # id-keyed memo entries before a wholesale reset

    def _spec_key(self, spec: FunctionSpec) -> tuple:
        """Value-identity for a spec: name/widths/ulp + bound fingerprint
        (names don't capture kwargs like sigmoid's input range).

        The id-keyed memo avoids re-hashing bounds for a spec object used
        across many calls; it pins the spec (id() must stay unique) and is
        reset at a size cap so a long-lived session fed a fresh spec object
        per request cannot grow without bound — the value key, and thus the
        envelope cache, is unaffected by a reset."""
        key = self._spec_keys.get(id(spec))
        if key is None:
            lo, hi = spec.bound_arrays()
            digest = hashlib.sha1(lo.tobytes() + hi.tobytes()).hexdigest()[:16]
            key = (spec.name, spec.in_bits, spec.out_bits, spec.ulp, digest)
            if len(self._spec_keys) >= self._SPEC_MEMO_CAP:
                self._spec_keys.clear()
                self._spec_refs.clear()
            self._spec_keys[id(spec)] = key
            self._spec_refs[id(spec)] = spec
            if len(self._bounds) >= 64:  # a few MB per spec at 16 bits
                self._bounds.clear()
            self._bounds.setdefault(key, (lo, hi))
        return key

    def _region_bounds(self, spec: FunctionSpec, lookup_bits: int):
        """``spec.region_bounds`` through a per-spec cache: the exact
        (rational-arithmetic) bound construction is paid once per spec, not
        once per probed R — min-R probes sweep many R over one spec."""
        key = self._spec_key(spec)
        arrs = self._bounds.get(key)
        if arrs is None:
            arrs = spec.bound_arrays()
            self._bounds[key] = arrs
        lo, hi = arrs
        r = 1 << lookup_bits
        return lo.reshape(r, -1), hi.reshape(r, -1)

    def _cached_spaces(self, key: tuple):
        """LRU lookup + hit accounting; call with _state_lock held."""
        spaces = self._spaces.get(key)
        if spaces is not None:
            self._spaces.move_to_end(key)
            self._space_hits += 1
        return spaces

    def _space_key(self, spec: FunctionSpec, lookup_bits: int, impl: str,
                   engine: str) -> tuple:
        # the batched engines do not consult `impl` (their searches are
        # value-identical to every IMPLS entry), so all impls share one entry
        return (*self._spec_key(spec), lookup_bits, engine,
                impl if engine == "pooled" else "-")

    def envelopes(self, spec: FunctionSpec, lookup_bits: int,
                  impl: str | None = None, engine: str | None = None
                  ) -> list[RegionSpace]:
        """Per-region §II envelopes — computed at most once per (spec, R),
        LRU-bounded at ``config.envelope_cache`` entries."""
        impl = impl or self.config.impl
        engine = engine or self.config.engine
        with self._state_lock:
            key = self._space_key(spec, lookup_bits, impl, engine)
            spaces = self._cached_spaces(key)
            if spaces is not None:
                return spaces
            L, U = self._region_bounds(spec, lookup_bits)
            spaces = compute_spaces(
                L, U, impl, engine,
                pool=self._get_pool() if engine == "pooled" else None,
                device=self.config.device)
            self._spaces[key] = spaces
            self._space_computes += 1
            cap = self.config.envelope_cache
            while cap is not None and len(self._spaces) > max(cap, 1):
                self._spaces.popitem(last=False)
                self._space_evictions += 1
            return spaces

    def _envelopes_fleet(self, pairs: list[tuple[FunctionSpec, int]]
                         ) -> list[list[RegionSpace]]:
        """Bulk twin of :meth:`envelopes` for the fleet paths: every missing
        (spec, R) of ``pairs`` is computed as one stacked array program
        (grouped by row width) and primed into the envelope LRU with the
        same accounting. Returns the spaces aligned with ``pairs``.

        With ``config.mesh > 1`` the stack runs on the float32 device
        program instead; those spaces are returned for the caller's
        immediate (re-verified) use but are NEVER primed into the cache —
        the exact batched engine's keys must keep answering with exact
        float64 verdicts, exactly as the ``pallas`` engine keeps its own.
        """
        impl, engine = self.config.impl, "batched"
        sharded = bool(self.config.mesh and self.config.mesh > 1)
        with self._state_lock:
            out: list = [None] * len(pairs)
            missing = []
            for i, (spec, r) in enumerate(pairs):
                spaces = self._cached_spaces(
                    self._space_key(spec, r, impl, engine))
                if spaces is None:
                    missing.append(i)
                else:
                    out[i] = spaces
            if missing:
                computed = fleet.fleet_region_spaces(
                    [self._region_bounds(*pairs[i]) for i in missing],
                    shards=self.config.mesh, device=self.config.device)
                cap = self.config.envelope_cache
                for i, spaces in zip(missing, computed):
                    out[i] = spaces
                    if sharded:
                        continue
                    spec, r = pairs[i]
                    self._spaces[self._space_key(spec, r, impl, engine)] = spaces
                    self._space_computes += 1
                    while cap is not None and len(self._spaces) > max(cap, 1):
                        self._spaces.popitem(last=False)
                        self._space_evictions += 1
            return out

    def prime_envelopes(self, pairs) -> None:
        """Bulk-prime the envelope cache for many (spec, lookup_bits) pairs
        as one fleet program — the batch-probe entry point the DSE study
        layer uses before walking its trials serially off the warm cache.

        No-op (the per-pair path will compute lazily) when the fleet is
        disabled, the engine isn't ``batched``, or ``mesh > 1`` (sharded
        f32 spaces never enter the exact engine's cache — see
        :meth:`_envelopes_fleet`).
        """
        if not (self.config.fleet and self.config.engine == "batched"):
            return
        if self.config.mesh and self.config.mesh > 1:
            return
        uniq, seen = [], set()
        for spec, r in pairs:
            key = (*self._spec_key(spec), r)
            if key not in seen:
                seen.add(key)
                uniq.append((spec, r))
        if uniq:
            self._envelopes_fleet(uniq)

    def feasible(self, spec: FunctionSpec, lookup_bits: int,
                 impl: str | None = None, engine: str | None = None) -> bool:
        """Eqns 9-10 over every region: does ANY piecewise quadratic exist?

        Under the batched engine this uses a lightweight all-regions verdict
        (no RegionSpace materialization) with its own boolean cache, so min-R
        probes don't churn the envelope LRU; cached envelopes are reused when
        present. The pooled and pallas engines answer from their own
        RegionSpaces — the verdict must come from the same arithmetic
        ``explore_r`` will judge with (the float32 pallas envelopes can
        disagree with the exact mask on marginal specs).
        """
        impl = impl or self.config.impl
        engine = engine or self.config.engine
        if engine != "batched":
            return all(s.feasible
                       for s in self.envelopes(spec, lookup_bits, impl, engine))
        with self._state_lock:
            spaces = self._cached_spaces(
                self._space_key(spec, lookup_bits, impl, engine))
            if spaces is not None:
                return all(s.feasible for s in spaces)
            fkey = (*self._spec_key(spec), lookup_bits)
            ok = self._feasible_get(fkey)
            if ok is None:
                L, U = self._region_bounds(spec, lookup_bits)
                ok = bool(batched.regions_feasible_mask(L, U).all())
                self._feasible_put(fkey, ok)
            return ok

    def min_regions(self, spec: FunctionSpec, r_max: int | None = None,
                    impl: str | None = None, engine: str | None = None
                    ) -> int | None:
        """Smallest feasible R — the paper's 'minimum number of regions'.

        Splitting a region leaves each half with a subset of the parent's
        constraints, so feasibility is monotone in R and the linear scan of
        the seed is wasteful twice over: it probes every R, and it starts at
        the *expensive* end (a probe at R costs O(4^in_bits / 2^R) element
        work, so R=0 is the worst probe in the whole sweep). This descends
        from ``r_max`` (cheap end) with exponentially growing steps while
        probes stay overhead-bound, dropping to single steps once element
        work dominates (each level down already quadruples the probe cost,
        so the *cost* keeps galloping and overshoot stays bounded), then
        binary-searches the final bracket. Any correct search must probe
        both min_R and min_R - 1; this pays O(1) such probes beyond them.
        Probes reuse cached envelopes/verdicts. The search itself lives in
        :class:`_MinRSearch`; :meth:`min_regions_many` locksteps it over a
        whole manifest through the fleet engine.
        """
        search = _MinRSearch(spec, r_max)
        while (r := search.next_probe()) is not None:
            search.feed(self.feasible(spec, r, impl, engine))
        return search.result

    def _feasible_cached(self, spec: FunctionSpec, lookup_bits: int
                         ) -> bool | None:
        """Cached-only feasibility verdict (spaces cache, then the boolean
        LRU) — the fleet paths consult this before bulk-probing."""
        with self._state_lock:
            spaces = self._cached_spaces(
                self._space_key(spec, lookup_bits, self.config.impl, "batched"))
            if spaces is not None:
                return all(s.feasible for s in spaces)
            return self._feasible_get((*self._spec_key(spec), lookup_bits))

    def min_regions_many(self, specs, r_max: int | None = None,
                         impl: str | None = None, engine: str | None = None
                         ) -> list[int | None]:
        """Fleet min-R: the monotone search for MANY specs in lockstep.

        Each round gathers every live search's next (spec, R) probe and
        answers the whole frontier with one stacked array program
        (``fleet.fleet_feasible_mask``) — a manifest's worth of min-R
        queries costs a handful of dispatches instead of F x R serial
        probes. Probe sequences per spec are identical to
        :meth:`min_regions` (same state machine), verdicts land in the same
        feasibility LRU, and results are bit-identical.
        """
        engine = engine or self.config.engine
        specs = list(specs)
        if not (self.config.fleet and engine == "batched") or len(specs) <= 1:
            return [self.min_regions(s, r_max, impl, engine) for s in specs]
        searches = [_MinRSearch(s, r_max) for s in specs]
        while True:
            pending: list[tuple[_MinRSearch, int]] = []
            for s in searches:
                while not s.done:
                    r = s.next_probe()
                    ok = self._feasible_cached(s.spec, r)
                    if ok is None:
                        pending.append((s, r))
                        break
                    s.feed(ok)
            if not pending:
                return [s.result for s in searches]
            mask = fleet.fleet_feasible_mask(
                [self._region_bounds(s.spec, r) for s, r in pending])
            with self._state_lock:
                for (s, r), ok in zip(pending, mask):
                    self._feasible_put((*self._spec_key(s.spec), r), bool(ok))
            for (s, _), ok in zip(pending, mask):
                s.feed(bool(ok))

    # -- exploration -------------------------------------------------------
    def explore_r(self, spec: FunctionSpec, lookup_bits: int,
                  target: str | Target | None = None,
                  degree: int | None = None, impl: str | None = None,
                  engine: str | None = None) -> ExploreEntry | None:
        """Run one target's decision procedure at a fixed LUT height."""
        tgt = get_target(target if target is not None else self.default_target)
        impl = impl or self.config.impl
        engine = engine or self.config.engine
        degree = degree if degree is not None else self.config.degree
        t0 = time.perf_counter()
        spaces = self.envelopes(spec, lookup_bits, impl, engine)
        if not all(s.feasible for s in spaces):
            return None
        k_max = (self.config.k_max if self.config.k_max is not None
                 else tgt.policy.k_max)
        out = _run_decision_pooled(
            spec, lookup_bits, degree, impl, k_max,
            self._get_pool() if engine == "pooled" else None,
            spaces=spaces, policy=tgt.policy, engine=engine,
            bounds=self._region_bounds(spec, lookup_bits))
        if out is None:
            return None
        design, report = out
        ad = tgt.estimate(design)
        return ExploreEntry(design, report, ad.area, ad.delay,
                            time.perf_counter() - t0,
                            tgt.objective(design, ad))

    def explore(self, spec: FunctionSpec | None = None,
                *, target: str | Target | None = None,
                lookup_bits: int | None = None,
                r_lo: int | None = None, r_hi: int | None = None,
                degree: int | None = None, impl: str | None = None,
                engine: str | None = None) -> DesignSpaceResult:
        """Sweep LUT heights under one target; returns the full frontier.

        Defaults come from the session config: a fixed ``lookup_bits`` if
        set, else ``[r_lo, r_hi]``, else [minimum feasible R, +6]. Swapping
        ``target`` re-decides over the *cached* envelopes — no regeneration.
        """
        spec = spec if spec is not None else self.config.spec()
        tgt = get_target(target if target is not None else self.default_target)
        degree = degree if degree is not None else self.config.degree
        if lookup_bits is None and r_lo is None and r_hi is None:
            # a per-call sweep request overrides a config-pinned height
            lookup_bits = self.config.lookup_bits
        min_r: int | None = None
        if lookup_bits is not None:
            heights = [lookup_bits]
        else:
            r_lo = r_lo if r_lo is not None else self.config.r_lo
            if r_lo is None:
                r_lo = min_r = self.min_regions(spec, impl=impl, engine=engine)
                if r_lo is None:
                    return DesignSpaceResult(spec.name, tgt.name, [], None)
            r_hi = r_hi if r_hi is not None else self.config.r_hi
            if r_hi is None:
                r_hi = min(spec.in_bits, r_lo + 6)
            heights = list(range(r_lo, r_hi + 1))
        # fleet path: prime every height's envelopes in one stacked program
        # (each height its own width group — no cross-height pad work) so the
        # per-R explore loop below runs entirely off the cache. Skipped under
        # mesh > 1: f32 device spaces never enter the exact engine's cache,
        # so priming would just duplicate the per-R exact computation.
        if (self.config.fleet and len(heights) > 1 and impl is None
                and (engine or self.config.engine) == "batched"
                and not (self.config.mesh and self.config.mesh > 1)):
            self._envelopes_fleet([(spec, r) for r in heights])
        entries = []
        for r in heights:
            e = self.explore_r(spec, r, tgt, degree, impl, engine)
            if e is not None:
                entries.append(e)
        return DesignSpaceResult(spec.name, tgt.name, entries, min_r)

    # -- table persistence (absorbed from numerics/registry) ---------------
    def _table_request(self, kind: str, bits: int | None,
                       lookup_bits: int | None, degree: int | None,
                       tgt: Target, kw: dict) -> tuple[str, int, int, int | None]:
        """Resolve one table request against the registry defaults; returns
        ``(cache key, bits, lookup_bits, degree)``. Shared by
        :meth:`get_table` and the fleet compile path so both produce the
        same artifacts under the same keys."""
        d_bits, _, d_r = DEFAULTS[kind]
        bits = bits if bits is not None else d_bits
        r = lookup_bits if lookup_bits is not None else d_r
        # resolve the session default now so the cache key names the degree
        # the design is actually generated with
        degree = degree if degree is not None else self.config.degree
        key = f"{kind}_{bits}b_R{r}_d{degree or 0}"
        if tgt.name != "asic":
            key += f"_{tgt.name}"
        if kw:  # spec overrides (ulp, out_bits, ...) change the artifact
            raw = "_".join(f"{k}{kw[k]}" for k in sorted(kw))
            key += "_" + re.sub(r"[^\w.\-]", "", raw)
        return key, bits, r, degree

    def _table_store(self, key: str, design: TableDesign) -> None:
        """Persist a verified design under ``key`` (tmp + atomic rename) and
        memoize it; call with ``self._lock`` held."""
        cache_dir = self.config.resolved_cache_dir()
        cache_dir.mkdir(parents=True, exist_ok=True)
        path = cache_dir / f"{key}.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(design.to_json())
        tmp.replace(path)
        self._tables[key] = design

    def get_table(self, kind: str, bits: int | None = None,
                  lookup_bits: int | None = None, degree: int | None = None,
                  target: str | Target | None = None, **kw) -> TableDesign:
        """Fetch (generating + verifying if needed) a cached table artifact.

        Disk layout and key format are the seed registry's, so existing
        ``artifacts/tables`` caches stay valid; non-default targets get a
        suffixed key.
        """
        tgt = get_target(target if target is not None else self.default_target)
        key, bits, r, degree = self._table_request(kind, bits, lookup_bits,
                                                   degree, tgt, kw)
        with self._lock:
            if key in self._tables:
                return self._tables[key]
            cache_dir = self.config.resolved_cache_dir()
            path = cache_dir / f"{key}.json"
            if path.exists():
                design = TableDesign.from_dict(json.loads(path.read_text()))
                self._tables[key] = design
                return design
            spec = spec_for(kind, bits, **kw)
            entry = None
            for r_try in range(r, min(bits, r + 4) + 1):
                entry = self.explore_r(spec, r_try, tgt, degree)
                if entry is not None:
                    break
            if entry is None:
                raise ValueError(f"no feasible table for {key}")
            ok, worst = entry.design.verify(spec)
            assert ok, f"unverified table {key}: worst={worst}"
            self._table_store(key, entry.design)
            return entry.design

    # -- compiled libraries (the runtime-side artifact) --------------------
    def compile(self, kinds=None, *, target: str | Target | None = None,
                **table_kw) -> InterpLibrary:
        """Compile a set of certified tables into one :class:`InterpLibrary`.

        ``kinds`` is an iterable of registry kind names or ``(kind, kwargs)``
        pairs (kwargs forwarded to :meth:`get_table` — bits, lookup_bits,
        ulp...); ``None`` compiles :data:`DEFAULT_LIBRARY_KINDS`, the full
        manifest of tables the interp numerics backend can touch. Each table
        comes through the session's persistence layer, so a warm cache makes
        this a pure pack step; a cold one generates + verifies once and the
        resulting artifact can be ``save``d so serving never explores again.

        Under the fleet engine (``config.fleet``, batched sessions) a cold
        compile stacks every cache-missing (kind, spec, R) probe into one
        array program and runs the decision procedures in lockstep
        (``core.fleet``) — bit-identical designs to the serial per-kind
        path, a handful of dispatches instead of F x R serial probes.
        The library is packed on ``config.device``.
        """
        items: list[tuple[str, dict]] = []
        for it in (DEFAULT_LIBRARY_KINDS if kinds is None else kinds):
            if isinstance(it, str):
                items.append((it, dict(table_kw)))
            else:
                kind, kw = it
                items.append((kind, {**table_kw, **dict(kw)}))
        if self.config.fleet and self.config.engine == "batched":
            designs = self._tables_fleet(items, target)
        else:
            designs = [self.get_table(kind, target=target, **kw)
                       for kind, kw in items]
        # non-default activation windows (lo/hi spec kwargs) must reach the
        # metadata, or the library-bound glue would quantize over the wrong
        # input range
        windows = {kind: (kw.get("lo", ACT_LO), kw.get("hi", ACT_HI))
                   for kind, kw in items if "lo" in kw or "hi" in kw}
        return InterpLibrary.from_designs(designs, [k for k, _ in items],
                                          act_windows=windows,
                                          device=self.config.device)

    def compile_segmented(self, kinds=None, *, segment=None,
                          target: str | Target | None = None,
                          **table_kw) -> InterpLibrary:
        """:meth:`compile`, with non-uniform (ROM v2) slots where they pay.

        ``segment`` names the kinds to try the greedy dyadic segmenter on
        (``None`` = every compiled kind). Each candidate kind is segmented
        with its uniform design's R as the depth cap (under the session's
        engine, on ``config.device``) and swapped in only when it stores
        strictly fewer ROM rows (per-leaf coefficients + packed segment
        table) than the uniform 2^R; accuracy is the same certificate,
        since both verify against the same bounds. The library is packed
        on ``config.device``.
        """
        from repro_torch.segment import explore_segmented

        items: list[tuple[str, dict]] = []
        for it in (DEFAULT_LIBRARY_KINDS if kinds is None else kinds):
            if isinstance(it, str):
                items.append((it, dict(table_kw)))
            else:
                kind, kw = it
                items.append((kind, {**table_kw, **dict(kw)}))
        seg_set = set(segment if segment is not None
                      else [k for k, _ in items])
        designs: list = []
        for kind, kw in items:
            kw = dict(kw)
            uni = self.get_table(kind, target=target, **kw)
            if kind in seg_set:
                bits = kw.pop("bits", None)
                kw.pop("lookup_bits", None)
                degree = kw.pop("degree", None)
                spec = spec_for(kind, bits, **kw)
                sd = explore_segmented(spec, max_depth=uni.lookup_bits,
                                       degree=degree,
                                       engine=self.config.engine,
                                       device=self.config.device)
                if sd is not None and sd.rows_used < (1 << uni.lookup_bits):
                    designs.append(sd)
                    continue
            designs.append(uni)
        windows = {kind: (kw.get("lo", ACT_LO), kw.get("hi", ACT_HI))
                   for kind, kw in items if "lo" in kw or "hi" in kw}
        return InterpLibrary.from_designs(designs, [k for k, _ in items],
                                          act_windows=windows,
                                          device=self.config.device)

    def _tables_fleet(self, items: list[tuple[str, dict]],
                      target: str | Target | None) -> list[TableDesign]:
        """Fleet twin of ``[self.get_table(kind, **kw) for ...]``.

        Warm keys (memory or disk) load exactly as :meth:`get_table` would;
        the cache-missing remainder is grouped by probe shape + degree, its
        envelopes computed as one stacked program (priming the envelope
        LRU), and each group's decision procedures run in lockstep with
        shared array work (``fleet.fleet_decisions`` — bit-identical per
        kind to the serial path). Results persist under the same disk keys.
        A kind the lockstep finds infeasible at its requested R falls back
        to :meth:`get_table`, which owns the R-retry ladder.
        """
        tgt = get_target(target if target is not None else self.default_target)
        reqs = []
        for kind, kw in items:
            kw = dict(kw)
            bits = kw.pop("bits", None)
            r = kw.pop("lookup_bits", None)
            dg = kw.pop("degree", None)
            key, bits, r, dg = self._table_request(kind, bits, r, dg, tgt, kw)
            reqs.append((kind, kw, key, bits, r, dg))
        designs: dict[int, TableDesign] = {}
        missing: list[int] = []
        with self._lock:
            for idx, (kind, kw, key, bits, r, dg) in enumerate(reqs):
                if key in self._tables:
                    designs[idx] = self._tables[key]
                    continue
                path = self.config.resolved_cache_dir() / f"{key}.json"
                if path.exists():
                    design = TableDesign.from_dict(json.loads(path.read_text()))
                    self._tables[key] = design
                    designs[idx] = design
                    continue
                missing.append(idx)
        # group cold probes by (shape, degree): one lockstep decision each
        groups: dict[tuple, list[tuple[int, FunctionSpec]]] = {}
        for idx in missing:
            kind, kw, key, bits, r, dg = reqs[idx]
            spec = spec_for(kind, bits, **kw)
            groups.setdefault(
                (r, spec.in_bits - r, dg), []).append((idx, spec))
        k_max = self.config.k_max  # None defers to the target policy's cap
        for (r, _, dg), members in groups.items():
            specs = [spec for _, spec in members]
            bounds = [self._region_bounds(spec, r) for spec in specs]
            spaces = self._envelopes_fleet([(spec, r) for spec in specs])
            results = fleet.fleet_decisions(
                specs, r, bounds, spaces, degree=dg, policy=tgt.policy,
                k_max=k_max if k_max is not None else tgt.policy.k_max)
            for (idx, spec), res in zip(members, results):
                kind, kw, key, bits, _, dg = reqs[idx]
                if res is None:  # rare: get_table owns the R-retry ladder
                    designs[idx] = self.get_table(kind, bits=bits,
                                                  lookup_bits=r, degree=dg,
                                                  target=tgt, **kw)
                    continue
                design, _report = res  # finalize_design already verified it
                with self._lock:
                    self._table_store(key, design)
                designs[idx] = design
        return [designs[i] for i in range(len(items))]


# ---------------------------------------------------------------------------
# Default session: what the deprecation shims and the serving stack use
# ---------------------------------------------------------------------------

_default: Explorer | None = None
_default_lock = threading.Lock()


def default_explorer() -> Explorer:
    """Process-wide Explorer used by ``repro_torch.api.get_table`` and the legacy
    ``generate_table`` / ``sweep_lub`` / ``registry.get_table`` shims."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Explorer()
        return _default


def set_default_explorer(explorer: Explorer) -> None:
    """Install ``explorer`` as the process-wide default session.

    Everything that resolves tables lazily (the numerics backends inside
    jitted model code, the legacy shims) goes through ``default_explorer()``;
    installing a configured session here is how a caller points all of it at
    one cache dir / worker pool."""
    global _default
    with _default_lock:
        _default = explorer


def get_table(kind: str, bits: int | None = None, lookup_bits: int | None = None,
              degree: int | None = None, **kw) -> TableDesign:
    """Module-level convenience: ``default_explorer().get_table(...)``."""
    return default_explorer().get_table(kind, bits, lookup_bits, degree, **kw)


def explore(spec: FunctionSpec | None = None, **kw) -> DesignSpaceResult:
    """Module-level convenience: ``default_explorer().explore(...)``."""
    return default_explorer().explore(spec, **kw)
