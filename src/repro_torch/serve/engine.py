"""Continuous-batching greedy serving engine (twin of
``repro/serve/engine.py``'s fused engine).

A fixed pool of ``slots`` holds one request's cache rows each. Admission
prefills the prompt (batch 1), splices its cache into a free slot and takes
the greedy first token. A tick then runs up to ``horizon`` decode steps for
every slot at once: decode -> argmax -> feed back, on the device, with one
device-to-host copy of the (steps, slots) token block per tick. Each slot
decodes at its own next position; dead slots keep decoding at a frozen
position (their rows are overwritten at the next admission). With interp
numerics the decode runs through the library-bound kernels.

Not in this port slice: faults and the degradation ladder, journal and
resume, AOT buckets, meshes, the host pipeline, plans, CUDA graphs. A
non-finite logit in a live slot raises instead of being streamed.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.api.library import InterpLibrary
from repro_torch.device import resolve
from repro_torch.kernels import build
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics

INTERP_BACKENDS = ("interp", "interp-fused")


class Rejected(ValueError):
    """Typed request rejection. ``reason`` is a stable key:
    ``"prompt_overflow"`` / ``"decode_overflow"`` (the request cannot fit
    the slot cache), ``"queue_full"`` (bounded queue), ``"bad_prompt"``
    (empty, or token ids outside the vocabulary)."""

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


class ServeEngine:
    """Continuous batching over a fixed slot pool (greedy decoding).

    ``library``: the :class:`InterpLibrary` interp numerics read; ``None``
    builds the default library on ``device``. Exact-numerics engines take
    none. ``stats`` counts ticks, decode steps, prefills, device-to-host
    transfers and, under ``"launches"``, each kernel's launches made by
    this engine.
    """

    def __init__(self, cfg, params: dict, slots: int, cache_len: int,
                 library: InterpLibrary | None = None, horizon: int = 8,
                 max_queue: int | None = 1024,
                 device: str | torch.device = "cuda"):
        self.device = resolve(device)
        self.cfg, self.params = cfg, params
        self.slots, self.cache_len = slots, cache_len
        self.horizon = max(1, int(horizon))
        self.max_queue = max_queue
        interp = cfg.numerics in INTERP_BACKENDS
        if not interp and library is not None:
            raise ValueError(f"library passed but cfg.numerics="
                             f"{cfg.numerics!r} never reads it")
        if interp and library is None:
            library = InterpLibrary.default_library(self.device)
        if library is not None and library.device != self.device:
            raise ValueError(f"library on {library.device}, engine on "
                             f"{self.device}")
        self.library = library
        self.numerics = get_numerics(cfg, library, fused=interp)
        self.caches = tf.init_cache(cfg, slots, cache_len, self.device)
        dev = self.device
        self._tok = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
        self._pos = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._live = torch.zeros(slots, dtype=torch.bool, device=dev)
        self.req: list[Request | None] = [None] * slots
        self._emitted = np.zeros(slots, np.int64)
        self.queue: collections.deque[Request] = collections.deque()
        self.finished: list[Request] = []
        self.stats = {"ticks": 0, "decode_steps": 0, "prefills": 0,
                      "transfers": 0, "rejected": 0,
                      "launches": dict.fromkeys(build.LAUNCHES, 0)}

    # -- admission control -------------------------------------------------
    def _reject(self, reason: str, message: str):
        self.stats["rejected"] += 1
        raise Rejected(reason, message)

    def submit(self, req: Request) -> None:
        """Enqueue a request, or raise :class:`Rejected`: decode writes KV
        rows at absolute positions up to len(prompt) + max_new - 2, which
        must fit the slot cache."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._reject("queue_full", f"request {req.rid}: queue full "
                         f"({len(self.queue)} >= {self.max_queue})")
        if len(req.prompt) == 0:
            self._reject("bad_prompt", f"request {req.rid}: empty prompt")
        pmin, pmax = int(np.min(req.prompt)), int(np.max(req.prompt))
        if pmin < 0 or pmax >= self.cfg.vocab_size:
            self._reject("bad_prompt", f"request {req.rid}: token id "
                         f"{pmin if pmin < 0 else pmax} outside vocab "
                         f"[0, {self.cfg.vocab_size})")
        if len(req.prompt) > self.cache_len:
            self._reject("prompt_overflow", f"request {req.rid}: prompt "
                         f"length {len(req.prompt)} exceeds cache_len "
                         f"{self.cache_len}")
        if len(req.prompt) + req.max_new - 1 > self.cache_len:
            self._reject("decode_overflow", f"request {req.rid}: prompt "
                         f"({len(req.prompt)}) + max_new ({req.max_new}) "
                         f"overflows cache_len {self.cache_len}")
        self.queue.append(req)

    # -- device work ---------------------------------------------------------
    def _count(self, before: dict) -> None:
        for name, n in build.LAUNCHES.items():
            self.stats["launches"][name] += n - before[name]

    @torch.inference_mode()
    def _admit_one(self, r: Request, s: int) -> None:
        """Prefill + splice into slot ``s`` + greedy first token."""
        before = dict(build.LAUNCHES)
        prompt = torch.as_tensor(np.asarray(r.prompt, np.int64),
                                 device=self.device)[None]
        logits, cache1 = tf.prefill(self.params, prompt, self.cfg,
                                    self.numerics, self.cache_len)
        tf.splice_cache(self.cfg, self.caches, cache1, s)
        first = torch.argmax(logits[0, -1])
        self._tok[s, 0] = first
        self._pos[s] = len(r.prompt)
        self._live[s] = True
        self._count(before)
        self.stats["prefills"] += 1
        tok = int(first)
        self.stats["transfers"] += 1
        self.req[s] = r
        self._emitted[s] = 1
        r.out.append(tok)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.req[s] is None and self.queue:
                self._admit_one(self.queue.popleft(), s)

    @torch.inference_mode()
    def _tick(self, steps: int) -> np.ndarray:
        """``steps`` decode -> argmax -> feed-back steps for every slot;
        returns the (steps, slots) token block (one transfer)."""
        before = dict(build.LAUNCHES)
        toks, ok = [], torch.ones(self.slots, dtype=torch.bool,
                                  device=self.device)
        for _ in range(steps):
            logits, self.caches = tf.decode_step(
                self.params, self._tok, self._pos, self.caches, self.cfg,
                self.numerics)
            ok &= torch.isfinite(logits[:, 0]).all(-1) | ~self._live
            nxt = torch.argmax(logits[:, 0], -1)
            nxt = torch.where(self._live, nxt, self._tok[:, 0])
            self._pos = torch.where(self._live, self._pos + 1, self._pos)
            self._tok = nxt[:, None]
            toks.append(nxt)
        block, ok = torch.stack(toks).cpu().numpy(), ok.cpu().numpy()
        self._count(before)
        self.stats["transfers"] += 1
        self.stats["ticks"] += 1
        self.stats["decode_steps"] += steps
        bad = [s for s, r in enumerate(self.req) if r is not None and not ok[s]]
        if bad:
            raise FloatingPointError(f"non-finite logits in live slots {bad}")
        return block

    def _retire(self) -> None:
        for s, r in enumerate(self.req):
            if r is not None and self._emitted[s] >= r.max_new:
                r.done = True
                self.finished.append(r)
                self.req[s] = None
                self._emitted[s] = 0
                self._live[s] = False

    def step(self, max_steps: int = 1) -> bool:
        """Admit, decode up to ``max_steps`` steps for every live slot
        (bounded by the smallest remaining budget, rounded down to a power
        of two as the reference does), retire. Returns False when idle."""
        self._admit()
        if all(r is None for r in self.req):
            return False
        remaining = min(r.max_new - int(self._emitted[s])
                        for s, r in enumerate(self.req) if r is not None)
        steps = max(1, min(max_steps, remaining))
        steps = 1 << (steps.bit_length() - 1)
        block = self._tick(steps)
        for s, r in enumerate(self.req):
            if r is not None:
                r.out.extend(int(t) for t in block[:, s])
                self._emitted[s] += steps
        self._retire()
        return True

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        t = 0
        while (self.queue or any(r is not None for r in self.req)) \
                and t < max_ticks:
            self.step(self.horizon)
            t += 1
        return self.finished
