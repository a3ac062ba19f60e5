"""Schema-versioned run records shared by DSE studies, bench snapshots and
numerics plans (twin of ``repro/dse/record.py``).

Every snapshot carries the same envelope: a ``schema`` version plus a
``meta`` block stamping the seed, the framework version and the device
platform the numbers were produced under (here ``"torch"`` and
``"cuda"`` / ``"cpu"`` where the reference writes ``"jax"`` and its
backend; readers of either package ignore ``meta``, so the ``tables`` of
one package's file load in the other's).

``update_snapshot`` is the single writer (``plan.save_plan`` goes through
it): it merges fresh tables into the existing snapshot, restamps ``meta``,
preserves a one-time ``*.pre-schema.json`` backup the first time it
migrates an unversioned file (so old numbers are never silently
destroyed), and writes via tmp + atomic rename.
"""
from __future__ import annotations

import datetime
import json
import pathlib
from typing import Any

RECORD_SCHEMA = 1


def run_meta(seed: int | None = None, *, stamp_time: bool = True,
             extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """Provenance block for a snapshot/artifact.

    ``stamp_time=False`` drops the timestamp — required for artifacts with
    a byte-reproducibility contract (the DSE frontier)."""
    import torch  # lazy: keep module import light for tooling

    meta: dict[str, Any] = {
        "seed": seed,
        "torch": torch.__version__,
        "platform": "cuda" if torch.cuda.is_available() else "cpu",
    }
    if stamp_time:
        meta["created"] = datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds")
    if extra:
        meta.update(extra)
    return meta


def _migrate_unversioned(path: pathlib.Path, existing) -> dict:
    """Lift a pre-schema snapshot into the versioned envelope, backing the
    original up exactly once. Handles both legacy layouts: the multi-table
    ``{table: rows}`` dict and the bare row *list* a per-table
    ``benchmarks.common.emit`` used to write (wrapped as ``{stem: rows}``)."""
    backup = path.with_name(path.stem + ".pre-schema.json")
    if not backup.exists():
        backup.write_text(json.dumps(existing, indent=1))
    if not isinstance(existing, dict):
        existing = {path.stem: existing}
    return {"schema": RECORD_SCHEMA, "meta": {}, "tables": existing}


def read_snapshot(path: str | pathlib.Path) -> dict[str, Any]:
    """Snapshot tables (empty dict when the file is absent). Accepts the
    versioned envelope and both legacy layouts (bare tables dict / bare
    row list keyed by the file stem)."""
    path = pathlib.Path(path)
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    if not isinstance(data, dict):
        return {path.stem: data}
    if "schema" in data and "tables" in data:
        return dict(data["tables"])
    return dict(data)


def update_snapshot(path: str | pathlib.Path, tables: dict[str, Any], *,
                    seed: int | None = None,
                    meta_extra: dict[str, Any] | None = None
                    ) -> dict[str, Any]:
    """Merge ``tables`` into the snapshot at ``path`` and restamp meta.

    Returns the full written document. Unversioned snapshots are migrated
    (with a ``*.pre-schema.json`` backup) instead of silently overwritten.
    """
    path = pathlib.Path(path)
    if path.exists():
        existing = json.loads(path.read_text())
        if not (isinstance(existing, dict) and "schema" in existing
                and "tables" in existing):
            existing = _migrate_unversioned(path, existing)
        elif existing["schema"] > RECORD_SCHEMA:
            raise ValueError(f"{path}: snapshot schema {existing['schema']} "
                             f"is newer than this code ({RECORD_SCHEMA})")
    else:
        existing = {"schema": RECORD_SCHEMA, "meta": {}, "tables": {}}
    out = {
        "schema": RECORD_SCHEMA,
        "meta": run_meta(seed, extra=meta_extra),
        "tables": {**existing["tables"], **tables},
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(out, indent=1, default=str))
    tmp.replace(path)
    return out
