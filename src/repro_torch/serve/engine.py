"""Fault-tolerant continuous-batching greedy serving engine (twin of
``repro/serve/engine.py``).

A fixed pool of ``slots`` holds one request's cache rows each. Admission
prefills the prompt (batch 1), splices its cache into a free slot and takes
the greedy first token. With ``fused=True`` (the default) a tick then runs
up to ``horizon`` decode steps for every slot at once: decode -> argmax ->
feed back -> position bump -> NaN/Inf sentinel, on the device, with one
device-to-host copy of the (steps, slots) token block and the (slots,)
sentinel per tick. Each slot decodes at its own next position; dead slots
keep decoding at a frozen position (their rows are overwritten at the next
admission). A config with SSM layers (Mamba2, the Jamba hybrid) holds a
``models.transformer.MixedCache``: each slot's conv window and recurrent
state beside the attention layers' K/V rows, all updated in place by the
decode; such configs admit exact-length prompts only (no bucketed packing:
a pad suffix would enter the state). A sliding-window config's slots are rings of
``min(cache_len, window)`` rows (``cache_len`` below the window is
refused): prompts and decodes past the window wrap, so ``submit`` checks
no overflow there. With interp numerics the decode runs through the library-bound
kernels. A VLM config (InternVL) serves as a text decoder, as the
reference's does: a ``Request`` carries no patches. An encoder-decoder
config (Whisper) is refused at construction: a ``Request`` carries no
frames either.

The tick is the reference's one-dispatch ``lax.scan``: on a CUDA device
``_tick_fn(steps)`` replays one captured ``torch.cuda.CUDAGraph`` per
power-of-two chunk size up to ``horizon``, captured at construction over
static slot-state buffers (``_tok``, ``_pos``, ``_live``, the sentinel
``_ok`` and the token block ``_block``, all updated in place) and the
cache pool (updated in place by ``gqa_decode`` / ``mla_decode`` /
``ssm_decode``). Before a capture one eager
decode step runs on a side stream over scratch slot state and a scratch
cache, so lazily built operands (kernel builds, cuBLAS workspaces, the
library's operand rows) exist before capture without touching the served
state. A graph bakes in addresses: when the parameters, the numerics, the
library or the cache pool are other objects than those it was captured
over (the degradation ladder; a caller assigning ``engine.library``), the
graphs are dropped and recaptured at the next tick. A configuration whose
decode reads device values on the host (the attention glue's chunk
liveness test, ``models.attention.decode_reads_host``) ticks eagerly, with
``stats["graph"]`` False and the reason in ``stats["graph_reason"]``; so
does ``graph=False`` (a debugging switch) and the CPU. A capture that
fails raises. ``build.LAUNCHES`` counts in the kernels' Python wrappers,
which a replay does not run: each graph's launches are recorded at capture
and added to ``stats["launches"]`` on every replay, so that it counts the
launches that ran. ``fused=False`` is the reference's serial oracle: per
token one decode forward with the unfused numerics (``InterpNumerics``
bound to the library: its glue around the ``library_eval`` /
``library_walk`` kernels), then a host argmax.

The serving-robustness layer is the reference's: bounded-queue
backpressure and per-request deadlines against an injectable ``clock``
(typed :class:`Rejected` errors, ``deadline_exceeded`` retirement); the
NaN/Inf sentinel retires a poisoned slot with ``"non_finite_output"``;
watchdog trips (a poisoned or stalled tick, ``max_tick_s``) walk the
degradation ladder fused -> serial with ``"interp-guarded"`` numerics ->
exact after ``watchdog_limit`` trips, and a resident-ROM integrity failure
(:meth:`InterpLibrary.verify_resident`, at construction, on a trip, and
every ``verify_rom_every`` ticks) jumps straight to exact; ``journal=``
writes the reference's admission / token journal
(:mod:`repro_torch.serve.journal`), and :meth:`resume` rebuilds an engine
from one, either package's.

A config carrying a :class:`repro_torch.plan.NumericsPlan` serves each
layer under its own numerics (``for_layer``) from a dict of libraries, one
per plan slot (``compile_plan_libraries`` at construction when none is
passed); a corrupt slot ROM moves only the layers that read it to exact
(:meth:`_degrade_slots`), and ``stats["degradations"]`` is then a dict
keyed by layer label. The graphs are keyed on each slot library's
identity too: replacing one entry of ``engine.library`` rebinds the
numerics and recaptures.

``aot_buckets=`` (:mod:`repro_torch.serve.aot`): short prompts pad to the
smallest bucket holding them and admit several at once through
``models.transformer.prefill_padded``; on a CUDA device each (bucket,
pack) admission is one graph, captured at construction in the pool of the
tick graphs, that prefills, splices every row into its slot and writes the
greedy first tokens into the static slot state and a static first-token
buffer. ``async_host=`` (:mod:`repro_torch.serve.pipeline`) moves the
token download, detokenize and journal writes to a worker thread; the
main thread keeps the (slots,) sentinel download. ``mesh`` waits for the
distribution slice.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.api.library import InterpLibrary, LibraryIntegrityError
from repro_torch.device import resolve
from repro_torch.faults.inject import crashpoint
from repro_torch.kernels import build
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import INTERP_BACKENDS, get_numerics
from repro_torch.serve import aot as aot_mod
from repro_torch.serve.journal import ServeJournal, load_requests
from repro_torch.serve.pipeline import HostPipeline


def _interp(cfg) -> bool:
    """Does this config's numerics read an InterpLibrary? A plan does as
    long as any site assignment is non-exact."""
    plan = getattr(cfg, "plan", None)
    if plan is not None:
        return plan.uses_interp
    return cfg.numerics in INTERP_BACKENDS


def _libraries(library) -> tuple:
    """The library objects an engine holds: a plan engine's dict values in
    order, a homogeneous engine's one library, or none."""
    if library is None:
        return ()
    return tuple(library.values()) if isinstance(library, dict) else (library,)


# the tick's chunk sizes: the powers of two up to ``horizon``
chunk_sizes = aot_mod.tick_chunk_sizes


class Rejected(ValueError):
    """Typed request rejection. ``reason`` is a stable key:
    ``"prompt_overflow"`` / ``"decode_overflow"`` (the request cannot fit
    the slot cache), ``"queue_full"`` (bounded queue), ``"bad_prompt"``
    (empty, or token ids outside the vocabulary), ``"deadline"`` (already
    expired at submit)."""

    def __init__(self, reason: str, message: str):
        self.reason = reason
        super().__init__(message)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    deadline: float | None = None  # absolute engine-clock seconds
    error: str | None = None  # structured failure ("deadline_exceeded", ...)


class ServeEngine:
    """Fault-tolerant continuous batching over a fixed slot pool (greedy).

    ``library``: the :class:`InterpLibrary` interp numerics read; ``None``
    builds the default library on ``device``. Exact-numerics engines take
    none. Assigning ``engine.library`` rebinds the numerics to it (the
    reference's tick reads the library it is handed on every call). A plan
    engine (``cfg.plan``) holds a dict of libraries keyed by plan slot
    (compiled at construction when ``library`` is None); replacing one of
    its entries rebinds the numerics too.

    ``fused`` (default): one tick per chunk of up to ``horizon`` decode
    steps (a CUDA graph replay on a CUDA device, the eager loop otherwise
    or with ``graph=False``). ``fused=False``: the serial oracle, one
    decode forward and a host argmax per token.

    The robustness knobs are the reference's: ``max_queue`` (``None`` =
    unbounded), ``deadline_s`` (default TTL; ``Request.deadline``, absolute,
    overrides), ``clock`` (``repro_torch.faults.FaultClock`` drives
    deadline and stall tests), ``watchdog_limit`` (trips tolerated before
    one rung down), ``max_tick_s`` (stall watchdog), ``verify_rom_every``
    (re-checksum the ROM every N ticks; 0 = at construction and on trips
    only), ``journal`` (a path or :class:`ServeJournal`; see
    :meth:`resume`).

    The serving tier's knobs are the reference's too: ``aot_buckets``
    (``True``: the default bucket table clipped to ``cache_len``; a tuple
    of prefill lengths or a :class:`BucketTable`; ``None``: exact-length
    admissions) with ``max_pack`` (packed groups are powers of two up to
    ``min(max_pack, slots)``); ``async_host`` with ``pipeline_depth`` (the
    bounded queue of the host worker; ``run()`` / ``close()`` drain it,
    and while running ``Request.out`` trails the card by up to that
    depth). Both need the fused engine.

    ``stats`` holds the reference's counters (``dispatches`` counts a tick
    as one, a serial token as two; ``transfers`` the host copies;
    ``aot_*`` / ``packed_*`` / ``admit_dispatches`` / ``async_*``) and the
    port's: ``prefills`` (prefill forwards: a packed admission is one);
    ``admit_replays`` (packed admissions replayed from a graph);
    ``launches``, each kernel's launches made by this engine (per forward
    times prefills + decode steps + resume replay steps); ``graph`` /
    ``graph_reason``; ``captures`` (tick and admission graphs) and
    ``capture_s``.
    """

    def __init__(self, cfg, params: dict, slots: int, cache_len: int,
                 library: InterpLibrary | dict | None = None,
                 fused: bool = True, horizon: int = 8,
                 max_queue: int | None = 1024,
                 deadline_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 watchdog_limit: int = 2, max_tick_s: float | None = None,
                 verify_rom_every: int = 0,
                 journal: str | ServeJournal | None = None,
                 aot_buckets=None, max_pack: int = 4,
                 async_host: bool = False, pipeline_depth: int = 4,
                 graph: bool | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        if graph is None:
            graph = self.device.type == "cuda"
        if graph and self.device.type != "cuda":
            raise ValueError(f"graph=True needs a CUDA device, not "
                             f"{self.device}")
        self.cfg, self.params = cfg, params
        self.slots, self.cache_len = slots, cache_len
        self.fused, self.horizon = bool(fused), max(1, int(horizon))
        self.max_queue = max_queue
        self.deadline_s = deadline_s
        self.clock = clock
        self.watchdog_limit = max(1, int(watchdog_limit))
        self.max_tick_s = max_tick_s
        self.verify_rom_every = max(0, int(verify_rom_every))
        self.graph = bool(graph)
        if getattr(cfg, "encoder", None) is not None:
            # the reference's engine takes such a config and fails inside
            # run(), where its prefill meets no frames
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: a Request carries no "
                f"encoder frames, so the engine cannot serve it; run "
                f"models.transformer.encoder_forward, prefill(cross=) and "
                f"decode_step(cross=) directly")
        if cfg.sliding_window is not None and cache_len < cfg.sliding_window:
            # the wrapped decode slot (pos % cache) would overwrite KV rows
            # that are still inside the attention window
            raise ValueError(
                f"cache_len {cache_len} < sliding_window "
                f"{cfg.sliding_window}: a windowed engine must retain the "
                f"full attention window")
        interp = _interp(cfg)
        if not interp and library is not None:
            raise ValueError(f"library passed but cfg.numerics="
                             f"{cfg.numerics!r} never reads it")
        if interp and library is None:
            if cfg.plan is not None:
                from repro_torch.plan.numerics import compile_plan_libraries

                library = compile_plan_libraries(cfg.plan,
                                                 device=self.device)
            else:
                library = InterpLibrary.default_library(self.device)
        for lib in _libraries(library):
            if lib.device != self.device:
                raise ValueError(f"library on {lib.device}, engine on "
                                 f"{self.device}")
        self.caches = tf.init_cache(cfg, slots, cache_len, self.device)
        dev = self.device
        # device slot state, updated in place (a graph bakes its addresses)
        self._tok = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
        self._pos = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._live = torch.zeros(slots, dtype=torch.bool, device=dev)
        self._ok = torch.ones(slots, dtype=torch.bool, device=dev)
        self._block = torch.zeros((self.horizon, slots), dtype=torch.int64,
                                  device=dev)
        # host mirrors: next position and current token per slot
        self.pos = np.zeros(slots, np.int32)
        self.cur = np.full(slots, -1, np.int32)
        self.req: list[Request | None] = [None] * slots
        # emitted-token counts owned by the main thread: retirement and
        # chunk sizing cannot read len(Request.out) once the host pipeline
        # extends it from its worker
        self._emitted = np.zeros(slots, np.int64)
        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self.failed: list[Request] = []
        # plan engines count degradations per layer label ("0", "rest", or
        # "engine" for whole-ladder rungs)
        self.stats = {"dispatches": 0, "transfers": 0, "ticks": 0,
                      "decode_steps": 0, "rejected": 0, "expired": 0,
                      "watchdog_trips": 0,
                      "degradations": {} if cfg.plan is not None else 0,
                      "rom_verifies": 0, "rom_faults": 0, "slot_failures": 0,
                      "resumed": 0, "resume_skipped_done": 0,
                      "resume_replay_steps": 0,
                      "aot_compiles": 0, "aot_hits": 0, "aot_misses": 0,
                      "aot_reshards": 0, "aot_fallbacks": 0,
                      "packed_admits": 0, "packed_requests": 0,
                      "admit_dispatches": 0,
                      "async_chunks": 0, "async_tokens": 0,
                      "prefills": 0, "admit_replays": 0,
                      "graph": False, "graph_reason": None,
                      "captures": 0, "capture_s": 0.0,
                      "launches": dict.fromkeys(build.LAUNCHES, 0)}
        self.faults: list[dict] = []  # structured fault / degradation log
        self._trips = 0  # watchdog trips since the last degradation
        self.journal = (journal if isinstance(journal, (ServeJournal,
                                                        type(None)))
                        else ServeJournal(journal))
        # bucketed (padded) prefill packing is only sound for pure
        # attention-cache decoders (prefill_padded refuses the rest)
        self._packable = (
            getattr(cfg, "sliding_window", None) is None
            and getattr(cfg, "encoder", None) is None
            and getattr(cfg, "frontend", None) is None
            and not tf.has_ssm(cfg))
        if aot_buckets is None:
            self.aot_buckets = None
        elif aot_buckets is True:
            self.aot_buckets = aot_mod.BucketTable.for_cache(cache_len)
        elif isinstance(aot_buckets, aot_mod.BucketTable):
            self.aot_buckets = aot_mod.BucketTable.for_cache(
                cache_len, aot_buckets.buckets)
        else:
            self.aot_buckets = aot_mod.BucketTable.for_cache(
                cache_len, aot_buckets)
        self._pack_sizes = aot_mod.pack_sizes(max_pack, slots)
        self._aot: set = set()  # programs prepared at construction
        if async_host and not self.fused:
            raise ValueError(
                "async_host=True requires the fused engine: the serial "
                "per-op path is the synchronous oracle")
        self.pipeline = (HostPipeline(
            journal=self.journal, depth=pipeline_depth,
            reserve=(self.horizon * slots if self.device.type == "cuda"
                     else None))
            if async_host else None)
        self._graphs: dict[int, tuple] = {}  # steps -> (graph, launches)
        # (bucket, pack) -> (graph, input buffer, firsts, launches)
        self._admit_graphs: dict[tuple, tuple] = {}
        self._graph_key: tuple | None = None
        self._graph_reason: str | None = None
        self._bound: tuple = ()
        self._pool = None
        self.library = library  # binds the numerics
        self._warm_aot()
        # serve-time ROM integrity: the load-time checksum catches a
        # corrupt artifact; this catches the resident copy going bad
        self.verify_library()
        if self._graph_state() is None and not self._graphs:
            self._capture(chunk_sizes(self.horizon))

    # -- numerics binding --------------------------------------------------
    @property
    def library(self):
        return self._library

    @library.setter
    def library(self, library) -> None:
        self._library = library
        self._bind()

    def _bind(self) -> None:
        """The numerics of the current cfg, library and rung (the graphs
        captured over the old ones go)."""
        self.numerics = get_numerics(
            self.cfg, self._library, fused=self.fused and _interp(self.cfg),
            device=self.device)
        self._bound = _libraries(self._library)
        self._graph_state()

    # -- the tick: one CUDA graph per chunk size, or the eager loop ---------
    def _graph_blocker(self) -> str | None:
        if not self.fused:
            return "serial: one decode forward and a host argmax per token"
        if not self.graph:
            return ("eager: no CUDA device" if self.device.type != "cuda"
                    else "eager: graph=False")
        rows = tf.kv_rows(self.caches)  # a windowed ring's s_eff
        if rows is not None and attn.decode_reads_host(rows, self.numerics):
            return (f"eager: decode attention over {rows} cache rows takes "
                    f"the glue path's chunk liveness test, a host read "
                    f"(models.attention.decode_reads_host)")
        return None

    def _graph_state(self) -> str | None:
        """Why the tick runs eagerly (None: it replays CUDA graphs). Rebinds
        the numerics when a library entry was replaced, and drops graphs
        captured over other parameters, numerics, libraries or cache than
        the engine's current ones."""
        libs = _libraries(self._library)
        if len(libs) != len(self._bound) or any(
                a is not b for a, b in zip(libs, self._bound)):
            self._bind()  # a plan engine's library entry was replaced
            return self._graph_reason
        key = (self.params, self.numerics, self._library, self.caches, *libs)
        if self._graph_key is None or len(key) != len(self._graph_key) or any(
                a is not b for a, b in zip(key, self._graph_key)):
            self._drop_graphs()
            self._graph_key = key
            self._graph_reason = self._graph_blocker()
            self.stats["graph"] = self._graph_reason is None
            self.stats["graph_reason"] = self._graph_reason
        return self._graph_reason

    def _drop_graphs(self) -> None:
        """Free the captured graphs and their memory pool (the allocator
        releases a pool with its last graph: a later capture takes a new
        one)."""
        self._graphs.clear()
        self._admit_graphs.clear()
        self._pool = None

    def _decode_chunk(self, steps: int, params, tok, pos, live, caches, ok,
                      block) -> None:
        """``steps`` decode -> argmax -> feed back -> position bump ->
        sentinel steps over every slot, updating ``tok``, ``pos``, ``ok``
        and ``block[:steps]`` in place (the body a graph captures)."""
        ok.fill_(True)
        for i in range(steps):
            logits, _ = tf.decode_step(params, tok, pos, caches, self.cfg,
                                       self.numerics)
            last = logits[:, 0]
            ok &= torch.isfinite(last).all(-1) | ~live
            nxt = torch.where(live, torch.argmax(last, -1), tok[:, 0])
            block[i].copy_(nxt)
            pos.copy_(torch.where(live, pos + 1, pos))
            tok.copy_(nxt[:, None])

    def _on_side_stream(self, body) -> None:
        """Run ``body(scratch cache, scratch tok, pos, live, ok, block)``
        eagerly on a side stream over scratch slot state and a scratch
        cache: builds what a capture may not create (kernel builds, cuBLAS
        handles and workspaces, the libraries' operand rows) and leaves the
        served state alone."""
        scratch = tf.init_cache(self.cfg, self.slots, self.cache_len,
                                self.device)
        state = [torch.zeros_like(t) for t in (self._tok, self._pos,
                                               self._live, self._ok,
                                               self._block)]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.inference_mode():
            body(scratch, *state)
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _warm_up(self) -> None:
        """One eager decode step over scratch state (see
        :meth:`_on_side_stream`)."""
        self._on_side_stream(
            lambda cache, tok, pos, live, ok, block: self._decode_chunk(
                1, self.params, tok, pos, live, cache, ok, block))

    def _capture(self, sizes) -> None:
        """Capture one graph per chunk size in ``sizes`` (raises on
        failure: a capture is never skipped quietly)."""
        t0 = time.perf_counter()
        self._warm_up()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        for steps in sizes:
            g = torch.cuda.CUDAGraph()
            before = dict(build.LAUNCHES)
            with torch.inference_mode(), torch.cuda.graph(g, pool=self._pool):
                self._decode_chunk(steps, self.params, self._tok, self._pos,
                                   self._live, self.caches, self._ok,
                                   self._block)
            self._graphs[steps] = (g, {k: n - before[k] for k, n
                                       in build.LAUNCHES.items()})
            self.stats["captures"] += 1
        torch.cuda.synchronize(self.device)
        self.stats["capture_s"] += time.perf_counter() - t0

    def _aot_hit(self, *key) -> None:
        """Count a lookup of a program in the construction table (the
        reference's executable-cache hit / miss: a key holds the cfg, so a
        degraded engine misses)."""
        if self.aot_buckets is None:
            return
        if (key[0], self.cfg, *key[1:]) in self._aot:
            self.stats["aot_hits"] += 1
        else:
            self.stats["aot_misses"] += 1

    def _tick_fn(self, steps: int) -> Callable:
        """The tick for a chunk of ``steps`` decode steps:
        ``(params, tok, pos, live, caches) -> (toks, tok, pos, ok,
        caches)``, a graph replay or the eager loop, called with the
        engine's own buffers (a replay reads those it was captured on),
        which it updates in place and returns."""
        self._aot_hit("tick", steps)
        if self._graph_state() is not None:
            return self._eager_tick(steps)
        if steps not in self._graphs:
            self._capture((steps,))
        return self._graph_tick(steps)

    def _eager_tick(self, steps: int) -> Callable:
        def tick(params, tok, pos, live, caches):
            with torch.inference_mode():
                self._decode_chunk(steps, params, tok, pos, live, caches,
                                   self._ok, self._block)
            return self._block[:steps], tok, pos, self._ok, caches
        return tick

    def _graph_tick(self, steps: int) -> Callable:
        g, launches = self._graphs[steps]

        def tick(params, tok, pos, live, caches):
            g.replay()  # on the buffers it was captured on
            for name, n in launches.items():
                self.stats["launches"][name] += n
            return self._block[:steps], tok, pos, self._ok, caches
        return tick

    # -- AOT: packed bucketed admission programs -----------------------------
    def _warm_aot(self) -> None:
        """Prepare every steady-state program at construction: the tick at
        each power-of-two chunk size up to ``horizon`` and one packed
        admission per (bucket, pack) pair. On a graph engine each is a
        captured graph (the ticks and admissions share one memory pool);
        otherwise the eager callables. ``stats["aot_compiles"]`` counts
        them."""
        if self.aot_buckets is None:
            return
        if not self.fused:
            raise ValueError("aot_buckets requires the fused engine")
        ticks = aot_mod.tick_chunk_sizes(self.horizon)
        admits = ([(b, pk) for b in self.aot_buckets.buckets
                   for pk in self._pack_sizes] if self._packable else [])
        graphed = self._graph_state() is None
        if graphed:
            self._capture([t for t in ticks if t not in self._graphs])
        for steps in ticks:
            self._aot.add(("tick", self.cfg, steps))
        for b, pk in admits:
            if graphed and self._admit_graphed(b):
                self._capture_admit(b, pk)
            self._aot.add(("admit_packed", self.cfg, b, pk))
        self.stats["aot_compiles"] += len(ticks) + len(admits)

    def _admit_graphed(self, bucket: int) -> bool:
        """Whether an admission at ``bucket`` replays a graph: the tick
        does, and the bucket's prefill reads nothing on the host
        (``models.attention.prefill_reads_host``)."""
        return (self._graph_state() is None
                and not attn.prefill_reads_host(bucket, self.numerics))

    def _admit_body(self, prompts, lens, slots, firsts, caches, tok, pos,
                    live) -> None:
        """The packed admission (the body an admission graph captures):
        prefill the right-padded ``prompts`` (P, bucket), splice row i's
        cache into slot ``slots[i]``, write its greedy first token into
        ``firsts[i]`` and the slot state (token, position ``lens[i]``,
        live), all on the device and in place."""
        logits, rows = tf.prefill_padded(self.params, prompts, lens,
                                         self.cfg, self.numerics,
                                         self.cache_len)
        first = torch.argmax(logits[:, 0], -1)
        firsts.copy_(first)
        tf.splice_cache_rows(self.cfg, caches, rows, slots)
        tok.index_copy_(0, slots, first[:, None])
        pos.index_copy_(0, slots, lens.to(torch.int32))
        live.index_fill_(0, slots, True)

    @staticmethod
    def _admit_views(inp: torch.Tensor, bucket: int, pk: int):
        """(prompts (P, bucket), lens (P,), slots (P,)) views of one int64
        input buffer (one host-to-device copy per admission)."""
        n = pk * bucket
        return (inp[:n].reshape(pk, bucket), inp[n:n + pk], inp[n + pk:])

    def _capture_admit(self, bucket: int, pk: int) -> None:
        """Capture the packed admission at (``bucket``, ``pk``) over static
        input and first-token buffers, after one eager run of it over
        scratch state."""
        t0 = time.perf_counter()
        dev = self.device
        inp = torch.zeros(pk * bucket + 2 * pk, dtype=torch.int64,
                          device=dev)
        prompts, lens, slots = self._admit_views(inp, bucket, pk)
        lens.fill_(1)
        slots.copy_(torch.arange(pk, device=dev))
        firsts = torch.zeros(pk, dtype=torch.int64, device=dev)
        self._on_side_stream(
            lambda cache, tok, pos, live, _ok, _block: self._admit_body(
                prompts, lens, slots, torch.zeros_like(firsts), cache, tok,
                pos, live))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        before = dict(build.LAUNCHES)
        with torch.inference_mode(), torch.cuda.graph(g, pool=self._pool):
            self._admit_body(prompts, lens, slots, firsts, self.caches,
                             self._tok, self._pos, self._live)
        torch.cuda.synchronize(dev)
        self._admit_graphs[bucket, pk] = (
            g, inp, firsts,
            {k: n - before[k] for k, n in build.LAUNCHES.items()})
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0

    def _packed_fn(self, bucket: int, pk: int) -> Callable:
        """The packed admission at (``bucket``, ``pk``): ``(inputs) ->
        firsts``, where ``inputs`` is the int64 host array of prompts, true
        lengths and slots (:meth:`_admit_views`' layout). A graph replay
        (captured now if the graphs were dropped since construction, as the
        reference's lazy jit compiles a missed shape) or the eager body."""
        self._aot_hit("admit_packed", bucket, pk)
        if self._admit_graphed(bucket):
            if (bucket, pk) not in self._admit_graphs:
                self._capture_admit(bucket, pk)
            g, inp, firsts, launches = self._admit_graphs[bucket, pk]

            def replay(host: np.ndarray) -> torch.Tensor:
                inp.copy_(torch.from_numpy(host))
                g.replay()
                for name, n in launches.items():
                    self.stats["launches"][name] += n
                self.stats["admit_replays"] += 1
                return firsts
            return replay

        def eager(host: np.ndarray) -> torch.Tensor:
            inp = torch.from_numpy(host).to(self.device)
            prompts, lens, slots = self._admit_views(inp, bucket, pk)
            firsts = torch.empty(pk, dtype=torch.int64, device=self.device)
            before = dict(build.LAUNCHES)
            with torch.inference_mode():
                self._admit_body(prompts, lens, slots, firsts, self.caches,
                                 self._tok, self._pos, self._live)
            self._count(before)
            return firsts
        return eager

    # -- fault handling: integrity, watchdog, degradation ladder ----------
    def _rung(self) -> str:
        """Current rung: fused, then serial (interp numerics only), then
        exact."""
        if self.fused:
            return "fused"
        return "serial" if _interp(self.cfg) else "exact"

    def _record_fault(self, reason: str, detail: str = "",
                      action: str = "", layers: tuple | None = None) -> None:
        entry = {"tick": self.stats["ticks"], "reason": reason,
                 "detail": detail, "action": action}
        if layers is not None:
            entry["layers"] = tuple(layers)
        self.faults.append(entry)

    def _count_degradation(self, label: str) -> None:
        d = self.stats["degradations"]
        if isinstance(d, dict):
            d[label] = d.get(label, 0) + 1
        else:
            self.stats["degradations"] = d + 1

    def verify_library(self) -> bool:
        """Re-checksum the resident ROM(s); on a mismatch degrade: a plan
        engine checks every slot library and moves only the layers reading
        a corrupt one to exact (:meth:`_degrade_slots`); a homogeneous
        engine jumps straight to exact (both interp rungs would read the
        corrupt ROM)."""
        if self._library is None:
            return True
        self.stats["rom_verifies"] += 1
        if isinstance(self._library, dict):
            bad: list[tuple[str, str]] = []
            for key in sorted(self._library):
                try:
                    self._library[key].verify_resident()
                except LibraryIntegrityError as e:
                    bad.append((key, str(e)))
            if not bad:
                return True
            self.stats["rom_faults"] += len(bad)
            self._degrade_slots([k for k, _ in bad], "rom_integrity",
                                detail="; ".join(m for _, m in bad))
            return False
        try:
            self._library.verify_resident()
            return True
        except LibraryIntegrityError as e:
            self.stats["rom_faults"] += 1
            self._degrade("rom_integrity", to="exact", detail=str(e))
            return False

    def _degrade_slots(self, slot_keys: list, reason: str,
                       detail: str = "") -> None:
        """The per-layer rung (plan engines): every site reading a poisoned
        slot library drops to exact, in the layers that read it only. The
        rest of the stack keeps its fused datapath; ``stats
        ["degradations"]`` and the fault log name the layers."""
        plan = self.cfg.plan
        keys = sorted(set(slot_keys))
        layers: list = []
        for k in keys:
            for lab in plan.layers_using_slot(k):
                if lab not in layers:
                    layers.append(lab)
        layers.sort(key=str)
        self.cfg = self.cfg.replace(plan=plan.degrade_layers(layers, keys))
        for lab in layers:
            self._count_degradation(str(lab))
        self._record_fault(reason, detail=detail,
                           action=f"slots:{','.join(keys)}->exact",
                           layers=tuple(str(x) for x in layers))
        self._trips = 0
        # rebinds the numerics; the graphs go with the old ones
        self.library = {k: v for k, v in self._library.items()
                        if k not in set(keys)} or None

    def _degrade(self, reason: str, to: str | None = None,
                 detail: str = "") -> None:
        """Walk one rung down the ladder (or jump to ``to``): fused ->
        serial swaps in the domain-guarded numerics for interp engines (a
        plan engine guards every interp site,
        :meth:`NumericsPlan.degrade_serial`) and drains and drops the host
        pipeline; -> exact drops the library (a plan: every site to exact).
        The KV pool and slot state carry over: in-flight requests keep
        decoding on the safer datapath."""
        was = self._rung()
        if to is None:
            to = "serial" if was == "fused" else "exact"
        if to == was:
            # already at (or below) the requested rung: log and keep going
            self._record_fault(reason, detail=detail, action=f"hold:{was}")
            self._trips = 0
            return
        plan = self.cfg.plan
        if to == "serial":
            self.fused = False
            # the serial rung is the synchronous oracle
            self._close_pipeline()
            if plan is not None:
                self.cfg = self.cfg.replace(plan=plan.degrade_serial())
            elif _interp(self.cfg) and self.cfg.numerics != "interp-guarded":
                self.cfg = self.cfg.replace(numerics="interp-guarded")
        elif to == "exact":
            if plan is not None:
                self.cfg = self.cfg.replace(plan=plan.degrade_exact())
            elif self.cfg.numerics != "exact":
                self.cfg = self.cfg.replace(numerics="exact")
        else:
            raise ValueError(f"unknown degradation rung {to!r}")
        self._count_degradation("engine")
        self._record_fault(reason, detail=detail, action=f"{was}->{to}")
        self._trips = 0
        if to == "exact":
            self.library = None  # rebinds the numerics
        else:
            self._bind()

    def _watchdog_trip(self, reason: str, detail: str = "") -> None:
        self.stats["watchdog_trips"] += 1
        self._trips += 1
        self._record_fault(reason, detail=detail, action="trip")
        # silent ROM corruption often presents as a poisoned datapath
        still_ok = self.verify_library()
        if still_ok and self._trips >= self.watchdog_limit:
            self._degrade(f"repeated_{reason}")

    def _journal(self, method: str, *args, crash: str | None = None) -> None:
        """One journal write. An async engine routes it through the host
        pipeline's queue, so it lands after every token emit queued before
        it (the single-writer order :meth:`resume` depends on); a sync
        engine writes and fsyncs inline, then hits the named crash
        point."""
        if self.journal is None:
            return
        if self.pipeline is not None:
            self.pipeline.journal_call(method, *args)
            return
        getattr(self.journal, method)(*args)
        if crash is not None:
            crashpoint(crash)

    def _free_slot(self, s: int) -> None:
        self.req[s] = None
        self.cur[s] = -1
        self.pos[s] = 0
        self._emitted[s] = 0
        self._live[s] = False

    def _fail_slot(self, s: int, error: str) -> None:
        """Retire a poisoned / expired slot with a structured error."""
        r = self.req[s]
        if r is None:
            return
        r.error = error
        self.failed.append(r)
        self.stats["slot_failures"] += 1
        self._free_slot(s)
        self._journal("fail", r.rid, error, crash="serve.fail.journaled")

    # -- admission control -------------------------------------------------
    def _reject(self, reason: str, message: str):
        self.stats["rejected"] += 1
        raise Rejected(reason, message)

    def submit(self, req: Request) -> None:
        """Enqueue a request, or raise :class:`Rejected`: without a sliding
        window, decode writes KV rows at absolute positions up to
        len(prompt) + max_new - 2, which must fit the slot cache (a
        windowed ring wraps); a request past its deadline is refused."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._reject("queue_full", f"request {req.rid}: queue full "
                         f"({len(self.queue)} >= max_queue {self.max_queue})")
        if len(req.prompt) == 0:
            self._reject("bad_prompt", f"request {req.rid}: empty prompt")
        pmin, pmax = int(np.min(req.prompt)), int(np.max(req.prompt))
        if pmin < 0 or pmax >= self.cfg.vocab_size:
            self._reject("bad_prompt", f"request {req.rid}: token id "
                         f"{pmin if pmin < 0 else pmax} outside vocab "
                         f"[0, {self.cfg.vocab_size})")
        if self.cfg.sliding_window is None:  # a windowed ring wraps
            if len(req.prompt) > self.cache_len:
                self._reject("prompt_overflow", f"request {req.rid}: prompt "
                             f"length {len(req.prompt)} exceeds cache_len "
                             f"{self.cache_len}")
            if len(req.prompt) + req.max_new - 1 > self.cache_len:
                self._reject("decode_overflow", f"request {req.rid}: prompt "
                             f"({len(req.prompt)}) + max_new ({req.max_new}) "
                             f"overflows cache_len {self.cache_len}")
        if req.deadline is None and self.deadline_s is not None:
            req.deadline = self.clock() + self.deadline_s
        if req.deadline is not None and self.clock() > req.deadline:
            self._reject("deadline", f"request {req.rid}: already past its "
                         f"deadline")
        self._journal("submit", req.rid, req.prompt, req.max_new,
                      req.deadline, crash="serve.submit.journaled")
        self.queue.append(req)

    def _expired(self, r: Request) -> bool:
        return r.deadline is not None and self.clock() > r.deadline

    def _fail_expired_queued(self, r: Request) -> None:
        """Expired while queued: fail without burning a prefill."""
        r.error = "deadline_exceeded"
        self.failed.append(r)
        self.stats["expired"] += 1
        self._journal("fail", r.rid, r.error)

    def _admit(self) -> None:
        if (self.aot_buckets is not None and self.fused
                and self._packable):
            self._admit_bucketed()
        else:
            self._admit_legacy()

    def _admit_legacy(self) -> None:
        for s in range(self.slots):
            while self.req[s] is None and self.queue:
                r = self.queue.popleft()
                if self._expired(r):
                    self._fail_expired_queued(r)  # keep draining into s
                    continue
                if r.out:  # resumed mid-stream: rebuild, emit nothing
                    self._admit_replay(r, s)
                else:
                    self._admit_one(r, s)
                break

    def _count(self, before: dict) -> None:
        for name, n in build.LAUNCHES.items():
            self.stats["launches"][name] += n - before[name]

    def _prefill_into(self, r: Request, s: int) -> torch.Tensor:
        """Prefill ``r``'s prompt and splice its cache into slot ``s``;
        returns the last position's logits."""
        prompt = torch.as_tensor(np.asarray(r.prompt, np.int64),
                                 device=self.device)[None]
        logits, cache1 = tf.prefill(self.params, prompt, self.cfg,
                                    self.numerics, self.cache_len)
        tf.splice_cache(self.cfg, self.caches, cache1, s)
        self.stats["prefills"] += 1
        return logits[0, -1]

    def _set_slot(self, s: int, tok, pos: int) -> None:
        """Slot ``s`` live at ``pos`` with current token ``tok`` (device
        state, in place)."""
        self._tok[s, 0] = tok
        self._pos[s] = pos
        self._live[s] = True

    @torch.inference_mode()
    def _admit_one(self, r: Request, s: int) -> None:
        """Exact-length admission of ``r`` into slot ``s``: prefill +
        splice + greedy first token (also the bucketed path's fallback for
        prompts longer than every bucket)."""
        self.stats["admit_dispatches"] += 1
        before = dict(build.LAUNCHES)
        first = torch.argmax(self._prefill_into(r, s))
        self._set_slot(s, first, len(r.prompt))
        self._count(before)
        self.req[s] = r
        self.pos[s] = len(r.prompt)
        self._emitted[s] = 1
        if self.pipeline is not None:
            # the first-token download and journal emit happen on the
            # worker, in order with every other journal write
            self.pipeline.emit_admit(((0, r),), first.reshape(1))
            return
        tok = int(first)
        r.out.append(tok)
        self.cur[s] = tok
        if self.journal is not None:
            self.journal.emit(r.rid, [tok])
            crashpoint("serve.admit.emitted")

    def _admit_bucketed(self) -> None:
        """Bucketed admission: drain the queue front into free slots in
        ascending order exactly as the legacy loop does (the (request,
        slot) mapping is fixed before grouping, so packing never reorders
        admissions), then group same-bucket admissions and admit each group
        as one padded packed prefill."""
        free = [s for s in range(self.slots) if self.req[s] is None]
        packed: list[tuple[Request, int, int]] = []
        while free and self.queue:
            r = self.queue.popleft()
            if self._expired(r):
                self._fail_expired_queued(r)
                continue
            s = free.pop(0)
            if r.out:  # resumed mid-stream: rebuild, emit nothing
                self._admit_replay(r, s)
                continue
            b = self.aot_buckets.bucket_for(len(r.prompt))
            if b is None:
                # longer than every bucket: exact-length prefill, counted
                self.stats["aot_fallbacks"] += 1
                self._admit_one(r, s)
                continue
            packed.append((r, s, b))
        by_bucket: dict[int, list] = {}
        for r, s, b in packed:
            by_bucket.setdefault(b, []).append((r, s))
        for b in sorted(by_bucket):
            group = by_bucket[b]
            while group:
                pk = max(c for c in self._pack_sizes if c <= len(group))
                sub, group = group[:pk], group[pk:]
                self._admit_packed(sub, b)

    def _admit_packed(self, sub: list, bucket: int) -> None:
        """One padded prefill admitting ``len(sub)`` requests."""
        pk = len(sub)
        host = np.zeros(pk * bucket + 2 * pk, np.int64)
        prompts, lens, slot_ix = self._admit_views(host, bucket, pk)
        for i, (r, s) in enumerate(sub):
            n = len(r.prompt)
            prompts[i, :n] = r.prompt
            lens[i] = n
            slot_ix[i] = s
        firsts = self._packed_fn(bucket, pk)(host)
        self.stats["admit_dispatches"] += 1
        self.stats["packed_admits"] += 1
        self.stats["packed_requests"] += pk
        self.stats["prefills"] += 1
        for r, s in sub:
            self.req[s] = r
            self.pos[s] = len(r.prompt)
            self._emitted[s] = 1
        if self.pipeline is not None:
            self.pipeline.emit_admit(
                tuple((i, r) for i, (r, _s) in enumerate(sub)), firsts)
            return
        vals = firsts.cpu().numpy()
        for i, (r, s) in enumerate(sub):
            tok = int(vals[i])
            r.out.append(tok)
            self.cur[s] = tok
            if self.journal is not None:
                self.journal.emit(r.rid, [tok])
        if self.journal is not None:
            crashpoint("serve.admit.emitted")

    @torch.inference_mode()
    def _admit_replay(self, r: Request, s: int) -> None:
        """Re-admit a journal-recovered in-flight request at its recorded
        position: prefill the prompt, then teacher-force the emitted tokens
        through the decode to rebuild the slot's cache rows. Nothing is
        re-emitted or re-journaled.

        The reference rebuilds at batch 1; here each forced step decodes
        the whole pool, as the original steps did, so that the rebuilt rows
        come from the same batch shape (a GEMM of another row count may sum
        in another order). The other slots are fed their current token at
        their next position. For a K/V row that is harmless: the step
        writes the row their next step writes anyway (dead slots: row 0,
        overwritten at admission). SSM state is cumulative instead: a
        forced step would advance every other slot's conv window and
        recurrent state by one token, so each step's SSM leaves are saved
        before it and every slot but ``s`` is restored after it."""
        before = dict(build.LAUNCHES)
        self._prefill_into(r, s)
        start = len(r.prompt)
        tok = np.maximum(self.cur, 0).astype(np.int64)
        pos = self.pos.copy()
        ssm = (tuple(self.caches.ssm)
               if isinstance(self.caches, tf.MixedCache) else ())
        for i, t in enumerate(r.out[:-1]):
            tok[s], pos[s] = t, start + i
            saved = [leaf.clone() for leaf in ssm]
            tf.decode_step(self.params,
                           torch.as_tensor(tok[:, None], device=self.device),
                           torch.as_tensor(pos, device=self.device),
                           self.caches, self.cfg, self.numerics)
            for leaf, old in zip(ssm, saved):
                old[:, s] = leaf[:, s]
                leaf.copy_(old)
            self.stats["resume_replay_steps"] += 1
        self._set_slot(s, int(r.out[-1]), start + len(r.out) - 1)
        self._count(before)
        self.req[s] = r
        self.pos[s] = start + len(r.out) - 1
        self.cur[s] = r.out[-1]
        self._emitted[s] = len(r.out)
        self.stats["resumed"] += 1

    def _retire(self) -> None:
        for s, r in enumerate(self.req):
            if r is None:
                continue
            # the main thread's emitted count, not len(r.out): the host
            # pipeline extends r.out from its worker
            if self._emitted[s] >= r.max_new:
                r.done = True
                self.finished.append(r)
                self._free_slot(s)
                self._journal("done", r.rid, crash="serve.retire.journaled")
            elif self._expired(r):
                self.stats["expired"] += 1
                self._fail_slot(s, "deadline_exceeded")

    # -- ticks -------------------------------------------------------------
    def step(self, max_steps: int = 1) -> bool:
        """Admit, decode up to ``max_steps`` steps for every live slot
        (bounded by the smallest remaining budget, rounded down to a power
        of two as the reference does; one step on the serial path),
        retire. Returns False when idle."""
        if self.pipeline is not None:
            self.pipeline.check()
        self._graph_state()  # rebinds after a replaced library entry
        if (self.verify_rom_every
                and self.stats["ticks"] % self.verify_rom_every == 0):
            self.verify_library()
        self._admit()
        if all(r is None for r in self.req):
            if self.pipeline is not None:
                # idle: drain, so callers reading Request.out see it all
                self._drain_pipeline()
            return False
        if not self.fused:
            return self._step_serial()
        remaining = min(r.max_new - int(self._emitted[s])
                        for s, r in enumerate(self.req) if r is not None)
        steps = max(1, min(max_steps, remaining))
        steps = 1 << (steps.bit_length() - 1)
        t0 = self.clock()
        tick = self._tick_fn(steps)
        before = dict(build.LAUNCHES)
        # the slot state and the cache are updated in place
        toks, _tok, _pos, ok, _caches = tick(self.params, self._tok,
                                             self._pos, self._live,
                                             self.caches)
        self._count(before)
        self.stats["dispatches"] += 1  # the tick
        if self.pipeline is not None:
            # async: only the (slots,) sentinel comes down here (poison
            # detection timing unchanged); the block is staged to the
            # worker after it
            return self._finish_tick(None, ok.cpu().numpy(), steps, t0,
                                     toks)
        # one device-to-host copy: the token block and the sentinel
        host = torch.cat([toks, ok[None].to(toks.dtype)]).cpu().numpy()
        out, ok = host[:-1], host[-1].astype(bool)
        return self._finish_tick(out, ok, steps, t0)

    def _step_serial(self) -> bool:
        """The serial oracle: token and position upload, one decode
        forward, argmax and sentinel, one download."""
        toks = torch.as_tensor(np.maximum(self.cur, 0)[:, None],
                               dtype=torch.int64, device=self.device)
        pos = torch.as_tensor(self.pos, dtype=torch.int32,
                              device=self.device)
        self.stats["transfers"] += 2  # token + position upload
        t0 = self.clock()
        before = dict(build.LAUNCHES)
        with torch.inference_mode():
            logits, _ = tf.decode_step(self.params, toks, pos, self.caches,
                                       self.cfg, self.numerics)
            self.stats["dispatches"] += 1  # the decode forward
            last = logits[:, 0]
            nxt_ok = torch.stack([torch.argmax(last, -1),
                                  torch.isfinite(last).all(-1).long()])
            self.stats["dispatches"] += 1  # argmax + sentinel
        host = nxt_ok.cpu().numpy()
        self._count(before)
        return self._finish_tick(host[:1], host[1].astype(bool), 1, t0)

    def _finish_tick(self, out: np.ndarray | None, ok: np.ndarray,
                     steps: int, t0: float, toks=None) -> bool:
        """Host side of a tick: stream the (steps, slots) block ``out`` to
        the healthy live slots (async: hand the device block ``toks`` to
        the host pipeline), retire the poisoned ones (their chunk is never
        streamed or journaled), the watchdog, retirement."""
        self.stats["transfers"] += 1
        self.stats["ticks"] += 1
        self.stats["decode_steps"] += steps
        tick_s = self.clock() - t0
        poisoned = [s for s, r in enumerate(self.req)
                    if r is not None and not ok[s]]
        alive = tuple((s, r) for s, r in enumerate(self.req)
                      if r is not None and s not in poisoned)
        if out is None:
            if alive:
                self.pipeline.emit_chunk(alive, toks)
            for s, _r in alive:
                self._emitted[s] += steps
                self.pos[s] += steps
        else:
            for s, r in alive:
                fresh = [int(t) for t in out[:, s]]
                r.out.extend(fresh)
                self.cur[s] = fresh[-1]
                self.pos[s] += steps
                self._emitted[s] += steps
                if self.journal is not None:
                    self.journal.emit(r.rid, fresh)
            if self.journal is not None:
                crashpoint("serve.tick.emitted")
        for s in poisoned:
            self._fail_slot(s, "non_finite_output")
        if poisoned:
            self._watchdog_trip("non_finite_output",
                                detail=f"slots {poisoned}")
        if self.max_tick_s is not None and tick_s > self.max_tick_s:
            self._watchdog_trip("stalled_tick",
                                detail=f"{tick_s:.3f}s > {self.max_tick_s}s")
        self._retire()
        return True

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        t = 0
        while (self.queue or any(r is not None for r in self.req)) \
                and t < max_ticks:
            self.step(self.horizon)
            t += 1
        self._drain_pipeline()
        return self.finished

    # -- async host pipeline lifecycle -------------------------------------
    def _drain_pipeline(self) -> None:
        """Block until the host worker has processed everything queued so
        far, fold its counters into ``stats`` and surface its exceptions.
        After this every finished request's ``out`` holds its stream."""
        if self.pipeline is None:
            return
        self.pipeline.flush()
        got = self.pipeline.drain_stats()
        self.stats["transfers"] += got.get("transfers", 0)
        self.stats["async_chunks"] += got.get("chunks", 0)
        self.stats["async_tokens"] += got.get("tokens", 0)

    def _close_pipeline(self) -> None:
        """Drain and drop the host pipeline; the engine goes on with
        synchronous host bookkeeping (the host mirror of each live slot's
        current token is taken from its stream)."""
        if self.pipeline is None:
            return
        self._drain_pipeline()
        self.pipeline.close()
        self.pipeline = None
        for s, r in enumerate(self.req):
            if r is not None and r.out:
                self.cur[s] = r.out[-1]

    def close(self) -> None:
        """Drain and close the host pipeline, close the journal's file and
        drop the captured graphs (their memory returns to the allocator).
        The engine stays usable: host bookkeeping goes on synchronously,
        the journal reopens at its next record, the graphs are recaptured
        at the next tick."""
        self._close_pipeline()
        if self.journal is not None:
            self.journal.close()
        self._drop_graphs()
        self._graph_key = None

    # -- crash recovery ----------------------------------------------------
    @classmethod
    def resume(cls, journal: str, cfg, params, *, slots: int, cache_len: int,
               **kw) -> "ServeEngine":
        """Reconstruct an engine from its admission / token journal (the
        reference's or the port's, sync or async: the records are the
        same).

        Completed (``done`` / ``fail``) requests are never replayed
        (``stats["resume_skipped_done"]`` counts them). In-flight requests
        are re-queued with their durable token prefix and re-admitted
        through the teacher-forced rebuild (:meth:`_admit_replay`):
        nothing already journaled is re-emitted, and the continued greedy
        decode produces bitwise the token suffix an uninterrupted run
        would have. The journal stays attached."""
        states = load_requests(journal)
        eng = cls(cfg, params, slots=slots, cache_len=cache_len,
                  journal=journal, **kw)
        for st in states.values():
            if not st.in_flight:
                eng.stats["resume_skipped_done"] += 1
                continue
            if len(st.out) >= st.max_new:
                # crashed between the last emit and the done record: the
                # request is complete; journal the terminal event now
                req = Request(st.rid, st.prompt, st.max_new,
                              out=list(st.out), done=True,
                              deadline=st.deadline)
                eng.finished.append(req)
                eng.stats["resume_skipped_done"] += 1
                if eng.journal is not None:
                    eng._journal("done", st.rid)
                continue
            eng.queue.append(Request(st.rid, st.prompt, st.max_new,
                                     out=list(st.out),
                                     deadline=st.deadline))
        return eng
