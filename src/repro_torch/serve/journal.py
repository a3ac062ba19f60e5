"""Crash-recoverable serve state: the engine's admission / token journal
(twin of ``repro/serve/journal.py``).

A journaled :class:`repro_torch.serve.engine.ServeEngine` appends one
fsync'd jsonl event per durability transition, through
:mod:`repro_torch.util.journal`:

    {"ev": "submit", "rid": 3, "prompt": [...], "max_new": 12,
     "deadline": null}
    {"ev": "emit",   "rid": 3, "toks": [17, 4, ...]}   # per tick, per req
    {"ev": "done",   "rid": 3}
    {"ev": "fail",   "rid": 3, "error": "deadline_exceeded"}

The records are the reference's, byte for byte, so a journal written by
either package's engine resumes in the other's.

After a kill at any instant, :meth:`ServeEngine.resume` folds the journal
into per-request replay states (:func:`load_requests`) and reconstructs
the in-flight work: completed requests are never replayed, emitted tokens
are never re-emitted, and, greedy decoding being deterministic, the
resumed engine's token suffix is bitwise the suffix an uninterrupted run
would have produced.

A torn final line (the append that died mid-crash) is dropped on load:
its tokens were never durable, and the resumed engine regenerates them.
Mid-file corruption raises :class:`ServeJournalCorrupt`.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from repro_torch.util.journal import JournalCorrupt, JournalWriter, read_journal

SERVE_JOURNAL_SCHEMA = 1


class ServeJournalCorrupt(JournalCorrupt):
    """The serve journal is damaged beyond a torn tail."""


class ServeJournal:
    """Append-side schema over a
    :class:`~repro_torch.util.journal.JournalWriter`."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._writer = JournalWriter(self.path)

    def close(self) -> None:
        self._writer.close()

    # -- events ------------------------------------------------------------
    def submit(self, rid: int, prompt, max_new: int,
               deadline: float | None) -> None:
        self._writer.append({
            "schema": SERVE_JOURNAL_SCHEMA, "ev": "submit", "rid": int(rid),
            "prompt": [int(t) for t in prompt], "max_new": int(max_new),
            "deadline": None if deadline is None else float(deadline)})

    def emit(self, rid: int, toks) -> None:
        if len(toks):
            self._writer.append({"ev": "emit", "rid": int(rid),
                                 "toks": [int(t) for t in toks]})

    def done(self, rid: int) -> None:
        self._writer.append({"ev": "done", "rid": int(rid)})

    def fail(self, rid: int, error: str) -> None:
        self._writer.append({"ev": "fail", "rid": int(rid),
                             "error": str(error)})


@dataclasses.dataclass
class ReplayState:
    """One request's durable state folded out of the journal."""

    rid: int
    prompt: np.ndarray
    max_new: int
    deadline: float | None = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: str | None = None

    @property
    def in_flight(self) -> bool:
        return not self.done and self.error is None


def load_requests(path: str | pathlib.Path) -> dict[int, ReplayState]:
    """Fold a serve journal into per-request replay states (rid-keyed,
    journal order preserved — dicts iterate in insertion order)."""
    events, _dropped = read_journal(path, corrupt=ServeJournalCorrupt)
    out: dict[int, ReplayState] = {}
    for e in events:
        ev, rid = e.get("ev"), e.get("rid")
        if ev == "submit":
            out[rid] = ReplayState(
                rid=rid, prompt=np.asarray(e["prompt"], np.int32),
                max_new=e["max_new"], deadline=e.get("deadline"))
        elif ev == "emit" and rid in out:
            out[rid].out.extend(int(t) for t in e["toks"])
        elif ev == "done" and rid in out:
            out[rid].done = True
        elif ev == "fail" and rid in out:
            out[rid].error = e.get("error", "unknown")
    return out
