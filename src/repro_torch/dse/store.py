"""Torn-write-safe study persistence: fsync'd jsonl journal + snapshot
(twin of ``repro/dse/store.py``).

Discipline (the shared :mod:`repro_torch.util.journal` machinery, same as
``InterpLibrary.save`` and the serve-state journal):
every journal append is one ``\\n``-terminated JSON line flushed and
``fsync``'d before the trial is considered durable; compaction writes the
full record set to ``snapshot.json`` via tmp + fsync + atomic rename and
only then resets the journal. Crash anywhere leaves a recoverable store:

  * killed mid-append → the torn final line is detected (no newline, or
    JSON parse failure on the *last* line only) and dropped; every earlier
    record survives. A torn line mid-file is real corruption and raises
    :class:`StoreCorrupt` instead of silently losing the tail.
  * killed between snapshot rename and journal reset → records exist in
    both; load dedups by trial key (first wins — re-journaled records are
    bit-identical by the determinism contract in trial.py).
"""
from __future__ import annotations

import json
import pathlib
from typing import Any

from repro_torch.dse.trial import TrialRecord
from repro_torch.util.journal import (JournalCorrupt, JournalWriter,
                                atomic_write_text, read_journal)

JOURNAL = "journal.jsonl"
SNAPSHOT = "snapshot.json"
SNAPSHOT_SCHEMA = 1


class StoreCorrupt(JournalCorrupt):
    """The on-disk study store is damaged beyond a torn tail."""


class StudyStore:
    """Append-only trial store under one study directory."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)
        self.journal_path = self.root / JOURNAL
        self.snapshot_path = self.root / SNAPSHOT
        self._writer = JournalWriter(self.journal_path)
        self.torn_tail_drops = 0  # incomplete final lines discarded on load

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "StudyStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._writer.close()

    # -- append ------------------------------------------------------------
    def append(self, record: TrialRecord) -> None:
        """Durably journal one record: write line, flush, fsync."""
        self.root.mkdir(parents=True, exist_ok=True)
        self._writer.append(record.to_dict())

    # -- load --------------------------------------------------------------
    def _journal_records(self) -> list[dict[str, Any]]:
        records, dropped = read_journal(self.journal_path, corrupt=StoreCorrupt)
        self.torn_tail_drops += dropped
        return records

    def _snapshot_records(self) -> list[dict[str, Any]]:
        if not self.snapshot_path.exists():
            return []
        try:
            snap = json.loads(self.snapshot_path.read_text(encoding="utf-8"))
        except json.JSONDecodeError as e:
            # snapshots are written atomically (tmp + rename): a damaged one
            # was never a valid snapshot, not a torn write
            raise StoreCorrupt(f"{self.snapshot_path}: undecodable") from e
        if snap.get("schema") != SNAPSHOT_SCHEMA:
            raise StoreCorrupt(f"{self.snapshot_path}: schema "
                               f"{snap.get('schema')!r} != {SNAPSHOT_SCHEMA}")
        return list(snap.get("records") or [])

    def load(self) -> dict[str, TrialRecord]:
        """All durable records, keyed by trial key (snapshot, then journal;
        first occurrence wins — see the crash-window note above)."""
        out: dict[str, TrialRecord] = {}
        for d in self._snapshot_records() + self._journal_records():
            rec = TrialRecord.from_dict(d)
            out.setdefault(rec.params.key, rec)
        return out

    # -- compaction --------------------------------------------------------
    def compact(self) -> None:
        """Fold the journal into ``snapshot.json`` and reset the journal.

        Write order is crash-safe: snapshot tmp → fsync → rename (the new
        snapshot is durable before the journal shrinks), then the journal
        is reset via an atomic empty-file rename. A crash between the two
        leaves duplicates, which ``load`` dedups.
        """
        records = self.load()
        self.close()  # the append handle's offset dies with the old journal
        self.root.mkdir(parents=True, exist_ok=True)
        snap = {"schema": SNAPSHOT_SCHEMA,
                "records": [r.to_dict() for r in records.values()]}
        atomic_write_text(self.snapshot_path,
                          json.dumps(snap, sort_keys=True,
                                     separators=(",", ":")))
        jtmp = self.journal_path.with_suffix(".jsonl.tmp")
        jtmp.write_text("")
        jtmp.replace(self.journal_path)
