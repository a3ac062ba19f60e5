"""The DSE launcher (``python -m repro_torch.launch.dse``) and the
schema-versioned snapshots (``repro_torch.dse.record``) on the CPU.

* Twins of ``tests/dse/test_record.py``, case for case (the port's
  ``meta`` stamps ``"torch"`` where the reference's stamps ``"jax"``).
* ``run`` -> ``resume --assert-no-exec`` -> ``check`` -> ``report`` on the
  smoke preset with ``--device cpu``; its frontier is FRONTIER_6.json's
  bytes outside ``meta`` once each point's ``segmentation`` is dropped
  (FRONTIER_6.json predates that axis), and ``check`` against it passes
  (the axis-superset rule). The exit codes are the reference CLI's on the
  same calls.
* ``--emit-bench`` writes the port's own untracked ``BENCH_6_torch.json``
  (its directory redirected to a temporary one here), never the
  committed ``BENCH_6.json``.
* ``plan --arch yi_6b --smoke --device cpu``.

The default Explorers run on fresh cache directories, and every study
lives in a temporary directory: nothing is written under ``artifacts/``.
"""
from __future__ import annotations

import hashlib
import json
import pathlib

import pytest
import torch

from repro import api as jax_api
from repro.launch import dse as rcli
from repro_torch import api
from repro_torch.api import Explorer, ExploreConfig
from repro_torch.dse.record import (RECORD_SCHEMA, read_snapshot, run_meta,
                                    update_snapshot)
from repro_torch.dse.space import SearchSpace
from repro_torch.launch import dse as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRONTIER_6 = ROOT / "artifacts" / "dse" / "FRONTIER_6.json"
BENCH_6 = ROOT / "artifacts" / "bench" / "BENCH_6.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fresh_default_sessions(tmp_path_factory):
    old, jold = api.default_explorer(), jax_api.default_explorer()
    api.set_default_explorer(Explorer(ExploreConfig(
        device="cpu", cache_dir=str(tmp_path_factory.mktemp("port")))))
    jax_api.set_default_explorer(jax_api.Explorer(jax_api.ExploreConfig(
        cache_dir=str(tmp_path_factory.mktemp("ref")))))
    yield
    api.set_default_explorer(old)
    jax_api.set_default_explorer(jold)


def _sha(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


# ---------------------------------------------------------------- record
# twins of tests/dse/test_record.py

def test_fresh_snapshot_is_versioned_and_stamped(tmp_path):
    path = tmp_path / "BENCH_X.json"
    doc = update_snapshot(path, {"t1": [{"a": 1}]}, seed=7)
    on_disk = json.loads(path.read_text())
    assert on_disk == doc
    assert on_disk["schema"] == RECORD_SCHEMA
    assert on_disk["meta"]["seed"] == 7
    assert on_disk["meta"]["torch"] == torch.__version__
    assert on_disk["meta"]["platform"]
    assert "created" in on_disk["meta"]
    assert on_disk["tables"] == {"t1": [{"a": 1}]}


def test_merge_keeps_other_tables(tmp_path):
    path = tmp_path / "BENCH_X.json"
    update_snapshot(path, {"t1": [1]}, seed=0)
    update_snapshot(path, {"t2": [2]}, seed=0)
    assert read_snapshot(path) == {"t1": [1], "t2": [2]}


def test_unversioned_snapshot_backed_up_not_overwritten(tmp_path):
    path = tmp_path / "BENCH_X.json"
    legacy = {"t1": [{"old": True}]}
    path.write_text(json.dumps(legacy))
    update_snapshot(path, {"t2": [2]}, seed=0)
    backup = tmp_path / "BENCH_X.pre-schema.json"
    assert json.loads(backup.read_text()) == legacy
    assert read_snapshot(path) == {"t1": [{"old": True}], "t2": [2]}
    update_snapshot(path, {"t3": [3]}, seed=0)
    assert json.loads(backup.read_text()) == legacy


def test_newer_schema_refused(tmp_path):
    path = tmp_path / "BENCH_X.json"
    path.write_text(json.dumps({"schema": RECORD_SCHEMA + 1, "tables": {}}))
    with pytest.raises(ValueError, match="newer"):
        update_snapshot(path, {"t": []})


def test_read_snapshot_handles_both_layouts(tmp_path):
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"t": [1]}))
    assert read_snapshot(legacy) == {"t": [1]}
    assert read_snapshot(tmp_path / "absent.json") == {}


def test_run_meta_time_stamp_optional():
    assert "created" in run_meta(0)
    meta = run_meta(0, stamp_time=False, extra={"measure": "none"})
    assert "created" not in meta
    assert meta["measure"] == "none"


def test_cli_run_report_check_roundtrip(tmp_path, capsys):
    """launch/dse.py end-to-end on a tiny proxy-only space."""
    space = SearchSpace(kinds=("recip",), lookup_bits=(4, 5, 6),
                        targets=("asic",), bits=(8,))
    space_file = tmp_path / "space.json"
    space_file.write_text(json.dumps(space.to_dict()))
    study_dir = tmp_path / "study"
    assert cli.main(["run", "--study", str(study_dir),
                     "--space-json", str(space_file),
                     "--measure", "none", "--device", "cpu"]) == 0
    assert cli.main(["resume", "--study", str(study_dir),
                     "--assert-no-exec", "--device", "cpu"]) == 0
    assert cli.main(["report", "--study", str(study_dir)]) == 0
    out = capsys.readouterr().out
    assert "frontier" in out and "asic" in out
    frontier = study_dir / "frontier.json"
    assert cli.main(["check", "--study", str(study_dir),
                     "--against", str(frontier)]) == 0
    doc = json.loads(frontier.read_text())
    doc["groups"]["asic"].append({"params": {"kind": "recip",
                                             "lookup_bits": 2},
                                  "metrics": {},
                                  "objectives": [0.0, 0.0, -1e9]})
    fake = tmp_path / "committed.json"
    fake.write_text(json.dumps(doc))
    assert cli.main(["check", "--study", str(study_dir),
                     "--against", str(fake)]) == 1
    assert cli.main(["resume", "--study", str(tmp_path / "nope"),
                     "--device", "cpu"]) == 2


# ---------------------------------------------------------------- the CLI

def test_cli_smoke_preset_lifecycle(tmp_path, capsys, monkeypatch):
    """run -> resume --assert-no-exec -> check -> report on the smoke
    preset; the frontier is FRONTIER_6.json's outside ``meta`` and the
    ``segmentation`` axis, and the committed snapshot keeps its bytes."""
    monkeypatch.setattr(cli, "BENCH_DIR", tmp_path)
    study, bench = tmp_path / "study6", tmp_path / cli.BENCH_SNAPSHOT
    bench6 = _sha(BENCH_6)
    assert cli.main(["run", "--study", str(study), "--preset", "smoke",
                     "--device", "cpu", "--emit-bench"]) == 0
    out = capsys.readouterr().out
    assert "executed 16, replayed 0" in out and str(bench) in out
    row = read_snapshot(bench)["dse_summary"][0]
    assert row["trials_recorded"] == 16 and row["probe_runs"] == 2
    assert json.loads(bench.read_text())["meta"]["torch"]
    assert cli.BENCH_SNAPSHOT == "BENCH_6_torch.json"
    assert [p.name for p in tmp_path.glob("BENCH_6*")] == [bench.name]
    assert cli.main(["resume", "--study", str(study), "--assert-no-exec",
                     "--device", "cpu"]) == 0
    assert "executed 0, replayed 16" in capsys.readouterr().out
    assert cli.main(["check", "--study", str(study), "--against",
                     str(FRONTIER_6)]) == 0
    assert "all 4 committed points attained" in capsys.readouterr().out
    assert cli.main(["report", "--study", str(study)]) == 0
    assert "## pallas-tpu (2 frontier points)" in capsys.readouterr().out
    fresh = json.loads((study / "frontier.json").read_text())
    committed = json.loads(FRONTIER_6.read_text())
    for doc in (fresh, committed):
        doc.pop("meta")
    for pts in fresh["groups"].values():
        for pt in pts:
            pt["params"].pop("segmentation")
    assert json.dumps(fresh, indent=1, sort_keys=True) == \
        json.dumps(committed, indent=1, sort_keys=True)
    assert _sha(BENCH_6) == bench6


def test_cli_resume_refuses_reexecution(tmp_path, capsys):
    """``--assert-no-exec`` exits 1 when a trial had to run (a partial
    study), and the reference's CLI answers the same calls alike."""
    space = SearchSpace(kinds=("recip",), lookup_bits=(4, 5), bits=(8,))
    space_file = tmp_path / "space.json"
    space_file.write_text(json.dumps(space.to_dict()))
    codes = []
    for name, main, dev in (("port", cli.main, ["--device", "cpu"]),
                            ("ref", rcli.main, [])):
        root = str(tmp_path / name)
        codes.append([
            main(["run", "--study", root, "--space-json", str(space_file),
                  "--measure", "none", "--max-trials", "1"] + dev),
            main(["resume", "--study", root, "--assert-no-exec"] + dev),
            main(["resume", "--study", root, "--assert-no-exec"] + dev),
            main(["check", "--study", str(tmp_path / "none"), "--against",
                  str(FRONTIER_6)]),
        ])
    assert codes[0] == codes[1] == [0, 1, 0, 2]
    assert "RESUME REGRESSION: 1 trials" in capsys.readouterr().err


def test_cli_plan_smoke_on_cpu(tmp_path, capsys):
    path = tmp_path / "plan.json"
    assert cli.main(["plan", "--arch", "yi_6b", "--smoke", "--device",
                     "cpu", "--save-plan", str(path)]) == 0
    out = capsys.readouterr().out
    assert "plan[yi_6b]" in out and "saved plan" in out
    doc = json.loads(path.read_text())
    assert doc["tables"]["numerics_plan"] and doc["meta"]["torch"]
