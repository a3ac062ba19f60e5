"""Measured decode throughput for DSE trials, via the real serve engine
(twin of ``repro/dse/probe.py``).

Each distinct serving shape — (arch, fused, horizon, batch) — is driven
through an actual :class:`ServeEngine` continuous-batching run on the
probe's device, serving interp numerics from a library compiled on that
device. Results are cached per shape: a study whose table axes fan out
over many (kind, R) values pays for each serving shape once.

Three modes (``MODES``):

  modeled   (default) tokens/sec from the engine's *deterministic* dispatch
            and transfer counters under a fixed per-dispatch cost model.
            The engine genuinely runs — the counters are measurements of
            the program structure — but the score is bit-reproducible
            across runs, hosts and devices (the engine has no EOS, so the
            counters do not depend on the random weights or the tokens),
            which is what lets a resumed study's frontier match an
            uninterrupted run byte-for-byte and lets ``launch/dse.py
            check`` regress against a committed frontier artifact.
  wall      wall-clock tokens/sec (best of ``repeats``; on a card the run
            ends in a synchronize), for humans sizing real hardware; never
            used for the frontier contract. In this mode the library is
            compiled at the trial's own LUT height, so R reaches the
            measured datapath.
  none      no serve run; the study's objectives are the table proxies.

The smoke model's weights come from the port's ``init_params(cfg, seed,
device)``, not the reference's initializer; the modeled score never reads
them. A retry runs the same engine on the same device: nothing falls back
to the CPU or to the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve

# deterministic cost model (seconds) for the modeled score: one host->device
# program dispatch vs one device<->host transfer. Absolute values only scale
# the axis; the ratios are the reference's. The plan assigner's throughput
# model (``plan/assign.py``) extends them below the tick.
DISPATCH_COST_S = 1e-4
TRANSFER_COST_S = 2e-5

MODES = ("modeled", "wall", "none")


class ProbeTimeout(RuntimeError):
    """A serve-probe trial exceeded its wall-clock budget (after retry)."""


class ServeProbe:
    """Shared serve-throughput prober for one study.

    ``timeout_s`` bounds one serve run's wall clock: a run that exceeds it
    (a wedged dispatch, a cold build on a contended host) is treated as a
    transient fault — the probe backs off ``backoff_s`` and retries ONCE,
    and only a second miss raises :class:`ProbeTimeout`. Transient
    exceptions from the engine get the same one-retry treatment. Retries
    are reported through the ``"probe_retries"`` side-channel (popped into
    ``TrialRecord.timing`` by the study, never cached, never in
    ``metrics``): the deterministic metrics split that the frontier
    contract regresses against is identical whether or not a retry
    happened.

    ``device`` (default ``"cuda"``, resolved through
    :func:`repro_torch.device.resolve`, so a missing card raises) holds
    the model, the library and the engine.
    """

    def __init__(self, mode: str = "modeled", *, seed: int = 0,
                 requests: int = 3, prompt_len: int = 8, max_new: int = 8,
                 cache_len: int = 64, repeats: int = 2,
                 timeout_s: float | None = None, backoff_s: float = 0.05,
                 device="cuda"):
        if mode not in MODES:
            raise ValueError(f"unknown probe mode {mode!r}; one of {MODES}")
        self.mode = mode
        self.device = resolve(device)
        self.seed, self.repeats = seed, repeats
        self.requests, self.prompt_len = requests, prompt_len
        self.max_new, self.cache_len = max_new, cache_len
        self.timeout_s, self.backoff_s = timeout_s, backoff_s
        self.runs = 0
        self.hits = 0
        self.retries = 0  # lifetime retry count across the study
        self._cache: dict[tuple, dict[str, Any]] = {}
        self._models: dict[str, tuple] = {}  # arch -> (cfg, params)
        self._libraries: dict[Any, Any] = {}
        self._explorer = None
        self._own_explorer = False

    def close(self) -> None:
        """Release the Explorer this probe made for its device (if any)."""
        if self._own_explorer:
            self._explorer.close()
        self._explorer, self._own_explorer = None, False

    # -- internals ---------------------------------------------------------
    def _key(self, p) -> tuple:
        key = (p.arch, p.fused, p.horizon, p.batch)
        if self.mode == "wall":
            key += (p.lookup_bits,)  # R reaches the measured ROM
        return key

    def _model(self, arch: str):
        if arch not in self._models:
            from repro_torch.configs.base import get_smoke_config
            from repro_torch.models import transformer as tf

            cfg = get_smoke_config(arch).replace(numerics="interp")
            params = tf.init_params(cfg, self.seed, self.device)
            self._models[arch] = (cfg, params)
        return self._models[arch]

    def _session(self):
        """The default Explorer where it sits on this probe's device, else
        one of the same configuration on this device."""
        if self._explorer is None:
            from repro_torch.api import Explorer, default_explorer

            ex = default_explorer()
            dev = torch.device(ex.config.device)
            if dev.type == self.device.type and (
                    dev.index is None or dev.index == self.device.index):
                self._explorer = ex
            else:
                self._explorer = Explorer(dataclasses.replace(
                    ex.config, device=str(self.device)))
                self._own_explorer = True
        return self._explorer

    def _library(self, lookup_bits: int | None):
        if lookup_bits not in self._libraries:
            kw = {} if lookup_bits is None else {"lookup_bits": lookup_bits}
            self._libraries[lookup_bits] = self._session().compile(**kw)
        return self._libraries[lookup_bits]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _serve_once(self, p) -> tuple[float, dict[str, Any], int]:
        from repro_torch.serve.engine import Request, ServeEngine

        cfg, params = self._model(p.arch)
        lib = self._library(p.lookup_bits if self.mode == "wall" else None)
        cache_len = max(self.cache_len, cfg.sliding_window or 0)
        eng = ServeEngine(cfg, params, slots=p.batch, cache_len=cache_len,
                          library=lib, fused=p.fused, horizon=p.horizon,
                          device=self.device)
        try:
            rng = np.random.default_rng(self.seed)
            for i in range(self.requests):
                prompt = rng.integers(0, cfg.vocab_size,
                                      self.prompt_len).astype(np.int32)
                eng.submit(Request(i, prompt, max_new=self.max_new))
            self._sync()
            t0 = time.perf_counter()
            done = eng.run()
            self._sync()
            dt = time.perf_counter() - t0
        finally:
            eng.close()
        if self.timeout_s is not None and dt > self.timeout_s:
            raise ProbeTimeout(
                f"serve probe for {self._key(p)} took {dt:.3f}s "
                f"(> timeout_s {self.timeout_s}s)")
        return dt, dict(eng.stats), sum(len(r.out) for r in done)

    def _serve_retrying(self, p) -> tuple[int, float, dict[str, Any], int]:
        """One serve run with the retry-once-with-backoff policy; returns
        ``(retries, wall_s, stats, tokens)``. The second failure — timeout
        or engine exception — propagates to the study, which records the
        trial as errored rather than wedging the whole run."""
        try:
            return (0, *self._serve_once(p))
        except Exception:
            time.sleep(self.backoff_s)
            self.retries += 1
            return (1, *self._serve_once(p))

    # -- public ------------------------------------------------------------
    def measure(self, p) -> dict[str, Any]:
        """Throughput metrics for trial params ``p`` (cached per shape).

        Returns ``{"tokens_per_s", "dispatches_per_token",
        "transfers_per_token", "throughput_mode"}`` plus (wall mode only)
        the raw wall tokens/sec under ``"wall_tokens_per_s"`` — only the
        deterministic fields belong in ``TrialRecord.metrics``.
        """
        if self.mode == "none":
            return {}
        key = self._key(p)
        if key in self._cache:
            self.hits += 1
            return dict(self._cache[key])
        self.runs += 1
        best_wall = float("inf")
        stats: dict[str, Any] = {}
        tokens = 0
        retried = 0
        for _ in range(self.repeats if self.mode == "wall" else 1):
            r, dt, stats, tokens = self._serve_retrying(p)
            retried += r
            best_wall = min(best_wall, dt)
        steps = max(stats.get("decode_steps", 0), 1)
        modeled_t = (stats.get("dispatches", 0) * DISPATCH_COST_S
                     + stats.get("transfers", 0) * TRANSFER_COST_S)
        out: dict[str, Any] = {
            "throughput_mode": self.mode,
            "dispatches_per_token": stats.get("dispatches", 0) / steps,
            "transfers_per_token": stats.get("transfers", 0) / steps,
        }
        if self.mode == "modeled":
            out["tokens_per_s"] = steps / max(modeled_t, 1e-12)
        else:
            out["tokens_per_s"] = tokens / max(best_wall, 1e-12)
            out["wall_tokens_per_s"] = out["tokens_per_s"]
        # the cache holds only the deterministic fields; a retry is a
        # wall-clock accident of THIS run and is reported, not replayed
        self._cache[key] = out
        out = dict(out)
        if retried:
            out["probe_retries"] = retried
        return out

    @property
    def stats(self) -> dict[str, int]:
        return {"runs": self.runs, "hits": self.hits,
                "retries": self.retries}
