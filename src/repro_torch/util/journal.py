"""Torn-write-safe persistence primitives (twin of
``repro/util/journal.py``, copied: the port imports nothing of ``repro``).

  * ``atomic_write_text`` / ``atomic_write_bytes``: tmp file -> flush ->
    ``fsync`` -> atomic rename. A crash at any instant leaves either the
    old complete file or the new complete file, never a torn mix.
  * ``JournalWriter``: an append-only jsonl journal where a record is
    durable only once its ``\\n``-terminated line has been flushed and
    ``fsync``'d. Opening for append first repairs the tail: a complete
    final record missing only its newline is terminated; a torn fragment
    (the append that wrote it died before fsync returned, so it was never
    durable) is truncated away.
  * ``read_journal``: parses a journal, dropping a torn *final* line
    (recoverable tail damage) but raising :class:`JournalCorrupt` for an
    undecodable line mid-file: that is real corruption, and silently
    dropping committed records behind it would be data loss.

Records are the reference's bytes (``json.dumps`` with sorted keys and
compact separators), so either package reads the other's journals.
:mod:`repro_torch.serve.journal` is a schema over these primitives.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Callable


class JournalCorrupt(RuntimeError):
    """A journal is damaged beyond a torn tail (mid-file corruption)."""


def atomic_write_bytes(path: str | pathlib.Path, data: bytes,
                       tmp_suffix: str = ".tmp") -> pathlib.Path:
    """Durably replace ``path`` with ``data``: tmp + flush + fsync + rename."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + tmp_suffix)
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)
    return path


def atomic_write_text(path: str | pathlib.Path, text: str,
                      tmp_suffix: str = ".tmp") -> pathlib.Path:
    return atomic_write_bytes(path, text.encode("utf-8"), tmp_suffix)


def trim_torn_tail(path: str | pathlib.Path) -> None:
    """Repair an unterminated journal tail in place (see module docstring)."""
    path = pathlib.Path(path)
    if not path.exists():
        return
    with open(path, "rb+") as f:
        data = f.read()
        if not data or data.endswith(b"\n"):
            return
        cut = data.rfind(b"\n") + 1
        try:
            json.loads(data[cut:].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            f.truncate(cut)
        else:
            f.write(b"\n")


def read_journal(path: str | pathlib.Path,
                 corrupt: Callable[[str], Exception] = JournalCorrupt
                 ) -> tuple[list[dict[str, Any]], int]:
    """All durable records of a jsonl journal, plus the count of torn
    final lines dropped. ``corrupt`` builds the exception raised on
    mid-file damage (lets callers surface their own error type)."""
    path = pathlib.Path(path)
    if not path.exists():
        return [], 0
    raw = path.read_text(encoding="utf-8")
    if not raw:
        return [], 0
    lines = raw.split("\n")
    if lines[-1] == "":
        lines.pop()  # the usual case: journal ends with a newline
    out: list[dict[str, Any]] = []
    dropped = 0
    last = len(lines) - 1
    for i, line in enumerate(lines):
        if line == "":
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            if i == last:
                # the final line only: a torn append (with or without its
                # newline) is recoverable tail damage
                dropped += 1
                continue
            raise corrupt(
                f"{path}: undecodable journal line {i + 1} (not the tail — "
                f"refusing to drop committed records)") from e
    return out, dropped


class JournalWriter:
    """Append-only fsync'd jsonl journal (lazily opened, tail-repairing)."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._fh = None

    def __enter__(self) -> "JournalWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def append(self, record: dict[str, Any]) -> None:
        """Durably journal one record: write line, flush, fsync."""
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            trim_torn_tail(self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
        line = json.dumps(record, sort_keys=True, separators=(",", ":"))
        self._fh.write(line + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
