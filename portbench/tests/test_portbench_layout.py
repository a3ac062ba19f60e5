"""``BENCHMARK.json`` against the harness's files: the loader finds every
cell, configuration and metric by its name, and every name, unit and
line keeps to the characters and lengths the benchmark allows."""
from __future__ import annotations

import json
import pathlib
import re

import pytest

from portbench import run as R

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert all(line(w) for w in BENCH["command"])
    assert all(PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cost = ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90
            + 1200)
    assert cost <= 43200


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    assert all(UNIT.fullmatch(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert line(m["layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_loader_finds_each_cell(cell):
    entry, work, cfg = R.load_cell(cell)
    assert entry["name"] == work["name"] == cell
    assert work["config"] == entry["config"] == cfg["name"]
    assert work["why"] == entry["why"]
    conf = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert conf["source"] == cfg["source"]
    assert conf["reduced"] == cfg["reduced"] == []
    # the file keeps the published values; what the program runs instead,
    # having no option to follow them, stands apart under ``as_run``
    published = R.load_json(ROOT / conf["file"])
    assert cfg == R.as_run(published)
    for k, v in published.get("as_run", {}).items():
        assert published.get(k) != v and published["why_as_run"]
    e2e = R.metric_names(cell, False)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert R.metric_names(cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_loader_finds_each_metric(metric):
    assert callable(R.reader(metric))
    m = next(x for x in METRICS if x["name"] == metric)
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in R.metric_names(cell, False)


def test_files_under_paths_are_named_from_names():
    for p in (ROOT / "portbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT).as_posix()
            assert PATH.fullmatch(rel), rel
