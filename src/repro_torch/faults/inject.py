"""Deterministic fault injectors for the serving-robustness chaos tests
(twin of ``repro/faults/inject.py``).

Four fault families, all seedable and process-local:

  ROM corruption      :func:`flip_rom_bit`: flip one bit of a compiled
                      :class:`repro_torch.api.InterpLibrary`'s resident
                      coefficient ROM while keeping its sealed checksum,
                      what a post-load memory fault looks like to
                      ``verify_resident()``.
  poisoned inputs     :func:`poison_prompt` (out-of-range token ids) and
                      :func:`poison_values` (NaN / Inf / huge floats planted
                      into an activation array): the inputs
                      ``GuardedNumerics`` and the admission checks catch.
  tick faults         :class:`TickFaultInjector`: wraps a ``ServeEngine``'s
                      tick (``engine._tick_fn(steps)``, an eager loop or a
                      CUDA graph replay) to delay a tick, drop it (no
                      progress), or replace its sentinel with a tripped one
                      (the engine watchdog) on a seeded schedule.
  crash points        :func:`crashpoint` / :func:`arm_crashpoint`: named
                      markers in the engine's journaled state transitions;
                      arming one makes the N-th hit raise :class:`Crashed`,
                      a kill-9 between two specific durability events.

Nothing here mutates global state except the crash-point registry, which
tests reset via :func:`reset_crashpoints`.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


# ---------------------------------------------------------------------------
# ROM corruption
# ---------------------------------------------------------------------------

def flip_rom_bit(library, *, seed: int = 0, bit: int | None = None):
    """A copy of ``library`` with ONE coefficient bit flipped but the
    original sealed checksum retained: ``verify_resident()`` on the result
    must fail. The flip location is drawn deterministically from ``seed``
    (or forced with ``bit``, an absolute bit index into the packed ROM);
    the copy lives on the library's device."""
    from repro_torch.api.library import InterpLibrary

    coeffs = np.array(library.coeffs.cpu().numpy(), np.int32)  # a copy
    nbits = coeffs.size * 32
    if bit is None:
        bit = int(np.random.default_rng(seed).integers(0, nbits))
    flat = coeffs.reshape(-1)
    flat[bit // 32] ^= np.int32(1) << np.int32(bit % 32)
    flipped = InterpLibrary(torch.from_numpy(coeffs).to(library.device),
                            library.metas)
    # carry the victim's baseline over: the flip must be detected, not
    # re-sealed away
    flipped.seal(library.sealed_sha or library.rom_sha())
    return flipped


# ---------------------------------------------------------------------------
# poisoned inputs
# ---------------------------------------------------------------------------

def poison_prompt(prompt: np.ndarray, vocab_size: int, *, seed: int = 0,
                  n: int = 1) -> np.ndarray:
    """Plant ``n`` out-of-range token ids into a copy of ``prompt`` — the
    admission-time validation target (an OOB id would silently clamp
    through the embedding gather and decode plausible-looking garbage)."""
    rng = np.random.default_rng(seed)
    out = np.array(prompt, np.int32)
    idx = rng.choice(len(out), size=min(n, len(out)), replace=False)
    out[idx] = vocab_size + rng.integers(1, 1 << 20, size=len(idx))
    return out


def poison_values(x, *, seed: int = 0, frac: float = 0.05,
                  kind: str = "nan"):
    """Plant non-finite (or absurdly large) values into a float array copy:
    ``kind`` in {"nan", "inf", "-inf", "huge"}. Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    out = np.array(x, np.float32)
    flat = out.reshape(-1)
    n = max(1, int(len(flat) * frac))
    idx = rng.choice(len(flat), size=n, replace=False)
    flat[idx] = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf,
                 "huge": 3.0e38}[kind]
    return out


# ---------------------------------------------------------------------------
# tick faults
# ---------------------------------------------------------------------------

class FaultClock:
    """A controllable monotonic clock for deadline/watchdog tests: pass as
    ``ServeEngine(clock=...)`` and ``advance`` it instead of sleeping."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += float(dt)


class TickFaultInjector:
    """Wrap a ``ServeEngine``'s tick with a seeded fault schedule.

    ``install(engine)`` interposes on ``engine._tick_fn``; each engine tick
    consults the schedule:

      "delay"   sleep ``delay_s`` (or advance the engine's FaultClock)
                before running the real tick: a wedged dispatch, visible
                to the stall watchdog;
      "nan"     run the real tick but replace its sentinel with a tripped
                one: the NaN/Inf watchdog fires as on a poisoned datapath;
      "drop"    skip the dispatch entirely: no tokens, no progress.

    ``every_n``: fault on ticks where ``tick_index % every_n == offset``
    (deterministic: no RNG on the schedule, runs replay exactly).
    """

    def __init__(self, mode: str = "nan", *, every_n: int = 2,
                 offset: int = 0, delay_s: float = 0.0, limit: int | None = 1):
        if mode not in ("delay", "nan", "drop"):
            raise ValueError(f"unknown tick fault mode {mode!r}")
        self.mode = mode
        self.every_n, self.offset = max(1, every_n), offset
        self.delay_s = delay_s
        self.limit = limit  # max faults to inject (None = unbounded)
        self.ticks = 0
        self.injected = 0

    def _due(self) -> bool:
        due = (self.ticks % self.every_n) == (self.offset % self.every_n)
        self.ticks += 1
        if not due or (self.limit is not None and self.injected >= self.limit):
            return False
        self.injected += 1
        return True

    def install(self, engine) -> "TickFaultInjector":
        real_tick_fn = engine._tick_fn
        injector = self

        def faulty_tick_fn(steps: int) -> Callable:
            real = real_tick_fn(steps)

            def tick(params, tok, pos, live, caches):
                due = injector._due()
                if due and injector.mode == "delay":
                    clk = getattr(engine, "clock", None)
                    if isinstance(clk, FaultClock):
                        clk.advance(injector.delay_s)
                    else:
                        time.sleep(injector.delay_s)
                if due and injector.mode == "drop":
                    # no dispatch at all: echo the inputs, zero tokens, and
                    # a tripped sentinel (a dropped tick is a fault)
                    b = tok.shape[0]
                    toks = torch.zeros((steps, b), dtype=tok.dtype,
                                       device=tok.device)
                    ok = torch.zeros((b,), dtype=torch.bool,
                                     device=tok.device)
                    return toks, tok, pos, ok, caches
                out = real(params, tok, pos, live, caches)
                if due and injector.mode == "nan":
                    toks, tok2, pos2, ok, caches2 = out
                    return toks, tok2, pos2, torch.zeros_like(ok), caches2
                return out

            return tick

        engine._tick_fn = faulty_tick_fn
        return self


# ---------------------------------------------------------------------------
# crash points (simulated kill-9 between durability events)
# ---------------------------------------------------------------------------

class Crashed(BaseException):
    """Simulated hard kill at a named crash point. Deliberately a
    ``BaseException``: ordinary ``except Exception`` recovery code must
    not swallow it, exactly like a real SIGKILL."""

    def __init__(self, point: str):
        self.point = point
        super().__init__(f"simulated crash at {point!r}")


_ARMED: dict[str, int] = {}  # point name -> remaining hits before crash


def arm_crashpoint(point: str, *, after: int = 0) -> None:
    """Arm ``point``: the ``after``-th subsequent hit raises (0 = next)."""
    _ARMED[point] = int(after)


def reset_crashpoints() -> None:
    _ARMED.clear()


def crashpoints_armed() -> dict[str, int]:
    return dict(_ARMED)


def crashpoint(point: str) -> None:
    """Marker compiled into crash-safe code paths; free when unarmed."""
    if not _ARMED:
        return
    left = _ARMED.get(point)
    if left is None:
        return
    if left <= 0:
        del _ARMED[point]
        raise Crashed(point)
    _ARMED[point] = left - 1
