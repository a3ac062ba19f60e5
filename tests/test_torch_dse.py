"""The persistent DSE (``repro_torch.dse``), the legacy generator shims
(``repro_torch.core.generate``) and the Remez baseline
(``repro_torch.core.remez``) against the reference, on the CPU.

* Twins of ``tests/dse/test_{study,store,probe_retry}.py``, case for case,
  with ``device="cpu"``.
* The committed ``artifacts/dse/study9`` replayed from a temporary copy (a
  study appends to its journal and rewrites ``frontier.json``; the
  committed files keep their bytes), the same 120 trials run fresh, under
  the batched engine and under ``engine="pallas"`` (the envelope
  kernels' plain versions), and studies handed between the packages.
* Frontiers equal the committed artifacts byte for byte once ``meta`` is
  removed (the port stamps ``"torch"`` and its device there); journal
  records are equal outside ``timing`` (wall clock).
* The shims and the Remez baseline: designs equal to the reference's
  field for field (integer arrays bitwise).

Both packages' default Explorers run on fresh cache directories here
(the serve probe compiles its library through the port's), so nothing is
written under ``artifacts/``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro import dse as rdse
from repro.core import generate as rgen
from repro.core import remez as rremez
from repro.dse.trial import TrialParams as RTrialParams
from repro_torch import api
from repro_torch.api import Explorer, ExploreConfig
from repro_torch.core import generate, remez
from repro_torch.core.funcspec import get_spec
from repro_torch.dse import (SearchSpace, Study, compare_frontiers,
                             load_frontier, smoke_space)
from repro_torch.dse.probe import ProbeTimeout, ServeProbe
from repro_torch.dse.space import PRESETS, default_space
from repro_torch.dse.store import StoreCorrupt, StudyStore
from repro_torch.dse.study import accuracy_margin_ulp
from repro_torch.dse.trial import TRIAL_SCHEMA, TrialParams, TrialRecord

ROOT = pathlib.Path(__file__).resolve().parents[1]
DSE = ROOT / "artifacts" / "dse"
STUDY9 = DSE / "study9"
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fresh_default_sessions(tmp_path_factory):
    """Both packages' default Explorers on fresh cache directories for this
    module, restored after."""
    old, jold = api.default_explorer(), jax_api.default_explorer()
    api.set_default_explorer(Explorer(ExploreConfig(
        device=CPU, cache_dir=str(tmp_path_factory.mktemp("port")))))
    jax_api.set_default_explorer(jax_api.Explorer(jax_api.ExploreConfig(
        cache_dir=str(tmp_path_factory.mktemp("ref")))))
    yield
    api.set_default_explorer(old)
    jax_api.set_default_explorer(jold)


def _without_meta(doc: dict) -> str:
    """A frontier document serialized as ``save_frontier`` writes it, with
    its ``meta`` block removed."""
    doc = {k: v for k, v in doc.items() if k != "meta"}
    return json.dumps(doc, indent=1, sort_keys=True)


def _file_digests(root: pathlib.Path) -> dict[str, str]:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.iterdir()) if p.is_file()}


def _study9_copy(tmp_path) -> pathlib.Path:
    dst = tmp_path / "study9"
    shutil.copytree(STUDY9, dst)
    return dst


def _journal(path: pathlib.Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


# ---------------------------------------------------------------- store
# twins of tests/dse/test_store.py

def _rec(i: int) -> TrialRecord:
    p = TrialParams(kind="recip", lookup_bits=4 + i, target="asic")
    return TrialRecord(p, "ok",
                       metrics={"area": float(10 * i), "delay": 2.0,
                                "accuracy_margin": i},
                       objectives=[float(10 * i), 2.0, -float(i)],
                       timing={"eval_s": 0.1 * i})


def test_store_roundtrip(tmp_path):
    with StudyStore(tmp_path / "s") as store:
        for i in range(4):
            store.append(_rec(i))
    loaded = StudyStore(tmp_path / "s").load()
    assert len(loaded) == 4
    for i in range(4):
        rec = loaded[_rec(i).params.key]
        assert rec.metrics == _rec(i).metrics
        assert rec.objectives == _rec(i).objectives
        assert rec.ok


def test_store_appends_are_fsynced(tmp_path, monkeypatch):
    import repro_torch.util.journal as journal_mod

    calls = []
    real_fsync = journal_mod.os.fsync
    monkeypatch.setattr(journal_mod.os, "fsync",
                        lambda fd: (calls.append(fd), real_fsync(fd))[1])
    with StudyStore(tmp_path / "s") as store:
        store.append(_rec(0))
        store.append(_rec(1))
    assert len(calls) == 2  # one fsync per durable append


def test_store_torn_tail_without_newline_dropped(tmp_path):
    store = StudyStore(tmp_path / "s")
    for i in range(3):
        store.append(_rec(i))
    store.close()
    with open(store.journal_path, "a") as f:
        f.write('{"schema": 1, "key": "torn", "par')
    reloaded = StudyStore(tmp_path / "s")
    assert len(reloaded.load()) == 3
    assert reloaded.torn_tail_drops == 1
    reloaded.append(_rec(7))  # the fragment is truncated first
    assert len(StudyStore(tmp_path / "s").load()) == 4


def test_store_unterminated_but_complete_record_kept(tmp_path):
    store = StudyStore(tmp_path / "s")
    store.append(_rec(0))
    store.append(_rec(1))
    store.close()
    data = store.journal_path.read_bytes()
    store.journal_path.write_bytes(data[:-1])
    reloaded = StudyStore(tmp_path / "s")
    assert len(reloaded.load()) == 2
    reloaded.append(_rec(2))  # terminated, never truncated
    assert len(StudyStore(tmp_path / "s").load()) == 3


def test_store_torn_final_line_with_newline_dropped(tmp_path):
    store = StudyStore(tmp_path / "s")
    for i in range(2):
        store.append(_rec(i))
    store.close()
    with open(store.journal_path, "a") as f:
        f.write('{"schema": 1, "key": "half\n')
    reloaded = StudyStore(tmp_path / "s")
    assert len(reloaded.load()) == 2
    assert reloaded.torn_tail_drops == 1


def test_store_mid_file_corruption_raises(tmp_path):
    store = StudyStore(tmp_path / "s")
    for i in range(3):
        store.append(_rec(i))
    store.close()
    lines = store.journal_path.read_text().splitlines()
    lines[1] = lines[1][:10]  # damage a NON-tail line
    store.journal_path.write_text("\n".join(lines) + "\n")
    with pytest.raises(StoreCorrupt):
        StudyStore(tmp_path / "s").load()


def test_store_compaction(tmp_path):
    store = StudyStore(tmp_path / "s")
    for i in range(5):
        store.append(_rec(i))
    before = store.load()
    store.compact()
    assert store.snapshot_path.exists()
    assert store.journal_path.read_text() == ""
    assert not list(store.root.glob("*.tmp"))
    after = StudyStore(tmp_path / "s").load()
    assert after.keys() == before.keys()
    assert all(after[k].to_dict() == before[k].to_dict() for k in after)
    store.append(_rec(9))
    assert len(StudyStore(tmp_path / "s").load()) == 6


def test_store_crash_between_snapshot_and_journal_reset_dedups(tmp_path):
    store = StudyStore(tmp_path / "s")
    for i in range(3):
        store.append(_rec(i))
    journal_bytes = store.journal_path.read_text()
    store.compact()
    store.journal_path.write_text(journal_bytes)
    assert len(StudyStore(tmp_path / "s").load()) == 3


def test_store_snapshot_schema_guard(tmp_path):
    store = StudyStore(tmp_path / "s")
    store.append(_rec(0))
    store.compact()
    doc = json.loads(store.snapshot_path.read_text())
    doc["schema"] = 99
    store.snapshot_path.write_text(json.dumps(doc))
    with pytest.raises(StoreCorrupt):
        StudyStore(tmp_path / "s").load()


def test_store_bytes_equal_reference(tmp_path):
    """The same records give the reference's journal and snapshot bytes."""
    from repro.dse.store import StudyStore as RStore
    from repro.dse.trial import TrialRecord as RRecord

    for cls, rcls, name in ((StudyStore, TrialRecord, "port"),
                            (RStore, RRecord, "ref")):
        with cls(tmp_path / name) as store:
            for i in range(3):
                store.append(rcls.from_dict(_rec(i).to_dict()))
            journal = store.journal_path.read_bytes()
            store.compact()
        (tmp_path / f"{name}.journal").write_bytes(journal)
    assert (tmp_path / "port.journal").read_bytes() == \
        (tmp_path / "ref.journal").read_bytes()
    assert (tmp_path / "port" / "snapshot.json").read_bytes() == \
        (tmp_path / "ref" / "snapshot.json").read_bytes()


# ---------------------------------------------------------------- trial / space

def test_trial_record_schema_and_unknown_fields():
    d = _rec(1).to_dict()
    assert TrialRecord.from_dict(d).to_dict() == d
    with pytest.raises(ValueError, match="schema"):
        TrialRecord.from_dict({**d, "schema": TRIAL_SCHEMA + 1})
    with pytest.raises(ValueError, match="unknown TrialParams fields"):
        TrialParams.from_dict({**d["params"], "mesh": 2})


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_space_order_and_keys_equal_reference(preset):
    """The enumeration order is part of the resume contract, and the keys
    are the journal's dedup keys: both are the reference's, byte for
    byte, and so is the study-file form of the space."""
    from repro.dse.space import PRESETS as RPRESETS

    space, rspace = PRESETS[preset](), RPRESETS[preset]()
    assert space.to_dict() == rspace.to_dict()
    assert SearchSpace.from_dict(rspace.to_dict()) == space
    keys = [p.key for p in space.trials()]
    assert keys == [p.key for p in rspace.trials()]
    assert len(keys) == len(space) == len(set(keys))
    assert all(TrialParams.from_dict(json.loads(k)).key == k for k in keys)


@pytest.mark.parametrize("fields", [
    {"kind": "log2", "lookup_bits": 5},
    {"kind": "recip", "lookup_bits": 4, "bits": 8},
    {"kind": "exp2", "lookup_bits": 6, "bits": 10, "out_bits": 10},
    {"kind": "silu", "lookup_bits": 6, "ulp": 2.0, "degree": 1},
])
def test_trial_spec_equals_reference(fields):
    """``TrialParams.spec()`` resolves widths as the reference does (the
    registry's kwargs at the default width, the maker's otherwise)."""
    p, rp = TrialParams(**fields), RTrialParams(**fields)
    assert p.key == rp.key and p.resolved_bits == rp.resolved_bits
    spec, rspec = p.spec(), rp.spec()
    assert (spec.name, spec.in_bits, spec.out_bits) == \
        (rspec.name, rspec.in_bits, rspec.out_bits)
    for a, b in zip(spec.bound_arrays(), rspec.bound_arrays()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- study
# twins of tests/dse/test_study.py

def _space() -> SearchSpace:
    return SearchSpace(kinds=("recip",), lookup_bits=(3, 4, 5, 6),
                       targets=("asic", "pallas-tpu"), bits=(8,),
                       fused=(True,), horizons=(4,), batches=(2,))


N = 8  # |_space()|


def _run_full(root, **kw):
    with Study(root, _space(), measure="none", name="t", device=CPU,
               **kw) as study:
        study.run()
        return study


def test_full_run_counts_and_artifacts(tmp_path):
    study = _run_full(tmp_path / "a")
    assert study.stats["executed"] == N
    assert study.stats["replayed"] == 0
    assert study.frontier_path().exists()
    front = load_frontier(study.frontier_path())
    assert front["objectives"] == ["area", "delay", "neg_accuracy_margin"]
    assert set(front["groups"]) <= {"asic", "pallas-tpu"}
    assert all(front["groups"].values())
    for pts in front["groups"].values():
        for pt in pts:
            assert pt["metrics"]["accuracy_margin"] >= 0
            assert pt["objectives"][2] == -pt["metrics"]["accuracy_margin"]
    assert front["meta"]["torch"] and front["meta"]["device"] == "cpu"


def test_resume_replays_zero_trials(tmp_path):
    _run_full(tmp_path / "a")
    bytes_before = (tmp_path / "a" / "frontier.json").read_bytes()
    with Study(tmp_path / "a", device=CPU) as resumed:
        resumed.run()
        assert resumed.stats["executed"] == 0
        assert resumed.stats["replayed"] == N
    assert (tmp_path / "a" / "frontier.json").read_bytes() == bytes_before


def test_kill_mid_run_resume_bit_identical(tmp_path):
    ref = _run_full(tmp_path / "a")
    with Study(tmp_path / "b", _space(), measure="none", name="t",
               device=CPU) as part:
        part.run(max_trials=3)
        assert part.stats["executed"] == 3
        journal = part.store.journal_path
    with open(journal, "a") as f:
        f.write('{"schema": 1, "key": "killed-mid-')  # torn tail
    assert not (tmp_path / "b" / "frontier.json").exists()
    with Study(tmp_path / "b", device=CPU) as resumed:
        resumed.run()
        assert resumed.stats["replayed"] == 3
        assert resumed.stats["executed"] == N - 3
    assert (tmp_path / "b" / "frontier.json").read_bytes() == \
        ref.frontier_path().read_bytes()


def test_compaction_preserves_frontier(tmp_path):
    study = _run_full(tmp_path / "a")
    bytes_before = study.frontier_path().read_bytes()
    with Study(tmp_path / "a", device=CPU) as again:
        again.run(compact=True)
    assert (tmp_path / "a" / "snapshot.json").exists()
    with Study(tmp_path / "a", device=CPU) as resumed:
        resumed.run()
        assert resumed.stats["executed"] == 0
        assert resumed.stats["replayed"] == N
    assert study.frontier_path().read_bytes() == bytes_before


def test_check_flags_injected_regression(tmp_path):
    study = _run_full(tmp_path / "a")
    fresh = load_frontier(study.frontier_path())
    assert compare_frontiers(fresh, fresh) == []
    committed = json.loads(json.dumps(fresh))
    committed["groups"]["asic"].append({
        "params": {"kind": "recip", "lookup_bits": 2},
        "metrics": {},
        "objectives": [0.0, 0.0, -1e9],
    })
    problems = compare_frontiers(fresh, committed)
    assert len(problems) == 1 and "no longer attained" in problems[0]
    renamed = dict(fresh, objectives=list(fresh["objectives"]) + ["extra"])
    assert "objective axes changed" in compare_frontiers(renamed, fresh)[0]
    missing = json.loads(json.dumps(fresh))
    del missing["groups"]["asic"]
    assert any("vanished" in p for p in compare_frontiers(missing, fresh))


def test_check_accepts_axis_superset(tmp_path):
    study = _run_full(tmp_path / "a")
    fresh = load_frontier(study.frontier_path())
    committed = json.loads(json.dumps(fresh))
    for pts in committed["groups"].values():
        for pt in pts:
            pt["params"].pop("segmentation", None)
    assert compare_frontiers(fresh, committed) == []
    problems = compare_frontiers(committed, fresh)
    assert problems and "segmentation" in problems[0]


def test_compare_frontiers_equals_reference(tmp_path):
    """The regression oracle gives the reference's verdicts (the messages
    included) on the cases above."""
    study = _run_full(tmp_path / "a")
    fresh = load_frontier(study.frontier_path())
    bad = json.loads(json.dumps(fresh))
    bad["groups"]["asic"].append({"params": {"kind": "recip",
                                             "lookup_bits": 2},
                                  "metrics": {},
                                  "objectives": [0.0, 0.0, -1e9]})
    stripped = json.loads(json.dumps(fresh))
    for pts in stripped["groups"].values():
        for pt in pts:
            pt["params"].pop("segmentation", None)
    for a, b in ((fresh, fresh), (fresh, bad), (stripped, fresh),
                 (fresh, stripped)):
        assert compare_frontiers(a, b) == rdse.compare_frontiers(a, b)


def test_measure_change_refused(tmp_path):
    _run_full(tmp_path / "a")
    with pytest.raises(ValueError, match="measure"):
        Study(tmp_path / "a", measure="modeled", device=CPU)


def test_margin_is_exact_envelope_slack():
    from repro_torch.api import get_table
    from repro_torch.api.config import spec_for

    design = get_table("recip", bits=8, lookup_bits=6)
    spec = spec_for("recip", 8)
    margin = accuracy_margin_ulp(design, spec)
    ok, worst = design.verify(spec)
    assert ok and worst == 0
    assert margin >= 0
    from repro.dse.study import accuracy_margin_ulp as ref_margin

    assert margin == ref_margin(design, spec)


def test_smoke_space_shape():
    space = smoke_space()
    trials = list(space.trials())
    assert len(trials) == len(space) == 16
    assert len({p.key for p in trials}) == 16
    assert SearchSpace.from_dict(space.to_dict()) == space


def test_modeled_probe_end_to_end(tmp_path):
    space = SearchSpace(kinds=("recip", "exp2neg"), lookup_bits=(6,),
                        targets=("asic",), fused=(True,), horizons=(4,),
                        batches=(2,), arch="yi_6b")
    with Study(tmp_path / "m", space, measure="modeled", name="m",
               device=CPU) as study:
        records = study.run()
        assert study.stats["executed"] == 2
        assert study.probe.stats == {"runs": 1, "hits": 1, "retries": 0}
        recs = [r for r in records.values() if r.ok]
        assert recs
        for rec in recs:
            assert rec.metrics["throughput_mode"] == "modeled"
            assert rec.metrics["tokens_per_s"] > 0
            assert len(rec.objectives) == 4
            assert rec.objectives[3] == -rec.metrics["tokens_per_s"]
    front = load_frontier((tmp_path / "m") / "frontier.json")
    assert front["objectives"][-1] == "neg_tokens_per_s"


def test_study_runs_on_its_device(tmp_path):
    """Each engine's Explorer and the probe sit on the study's device,
    whatever device the ExploreConfig handed in names."""
    with Study(tmp_path / "d", _space(), measure="none", device=CPU,
               explore=ExploreConfig(device="cuda")) as study:
        for engine in ("batched", "pallas"):
            assert study._explorer(engine).config.device == "cpu"
            assert study._explorer(engine).config.engine == engine
        assert study.probe.device == torch.device("cpu")


# ---------------------------------------------------------------- probe
# twins of tests/dse/test_probe_retry.py

def _params(**kw):
    base = dict(kind="recip", lookup_bits=4, target="asic", arch="yi_6b",
                fused=True, horizon=4, batch=2)
    base.update(kw)
    return TrialParams(**base)


def test_transient_failure_retried_once_and_reported(monkeypatch):
    probe = ServeProbe("modeled", backoff_s=0.0, device=CPU)
    real = probe._serve_once
    failures = {"left": 1}

    def flaky(p):
        if failures["left"]:
            failures["left"] -= 1
            raise RuntimeError("transient device loss")
        return real(p)

    monkeypatch.setattr(probe, "_serve_once", flaky)
    out = probe.measure(_params())
    assert out["probe_retries"] == 1
    assert probe.retries == 1
    assert probe.stats["retries"] == 1
    clean = ServeProbe("modeled", device=CPU).measure(_params())
    out.pop("probe_retries")
    assert out == clean
    again = probe.measure(_params())
    assert "probe_retries" not in again
    assert probe.hits == 1


def test_second_failure_propagates(monkeypatch):
    probe = ServeProbe("modeled", backoff_s=0.0, device=CPU)

    def always_down(p):
        raise RuntimeError("device is gone")

    monkeypatch.setattr(probe, "_serve_once", always_down)
    with pytest.raises(RuntimeError, match="device is gone"):
        probe.measure(_params())
    assert probe.retries == 1


def test_timeout_raises_after_retry():
    probe = ServeProbe("modeled", timeout_s=0.0, backoff_s=0.0, device=CPU)
    with pytest.raises(ProbeTimeout, match="timeout_s"):
        probe.measure(_params())
    assert probe.retries == 1


def test_study_records_retries_in_timing(tmp_path, monkeypatch):
    space = SearchSpace(kinds=("recip",), lookup_bits=(4,), targets=("asic",),
                        bits=(8,), fused=(True,), horizons=(4,), batches=(2,))
    with Study(tmp_path / "s", space, measure="modeled", name="t",
               device=CPU) as study:
        real = study.probe._serve_once
        failures = {"left": 1}

        def flaky(p):
            if failures["left"]:
                failures["left"] -= 1
                raise RuntimeError("transient")
            return real(p)

        monkeypatch.setattr(study.probe, "_serve_once", flaky)
        monkeypatch.setattr(study.probe, "backoff_s", 0.0)
        records = study.run()
    (rec,) = records.values()
    assert rec.timing.get("retries") == 1
    assert "retries" not in rec.metrics and "probe_retries" not in rec.metrics


@pytest.mark.parametrize("fused,batch", [(False, 2), (True, 2), (False, 8),
                                         (True, 8)])
def test_modeled_probe_counters_equal_reference(fused, batch):
    """The four serving shapes of the default space: the engine's
    dispatch / transfer counters, hence the modeled score, are the
    reference's (serial 2 dispatches and 3 transfers a token)."""
    p = _params(fused=fused, batch=batch, horizon=8)
    got = ServeProbe("modeled", device=CPU).measure(p)
    want = rdse.ServeProbe("modeled").measure(RTrialParams(**p.to_dict()))
    assert got == want


def test_wall_probe_keys_on_lookup_bits():
    """Under ``wall`` the library is compiled at the trial's R (its own
    cache entry); the wall figure goes to ``wall_tokens_per_s``."""
    probe = ServeProbe("wall", repeats=1, device=CPU)
    a = probe.measure(_params(lookup_bits=5))
    probe.measure(_params(lookup_bits=6))
    probe.measure(_params(lookup_bits=5))
    assert probe.stats == {"runs": 2, "hits": 1, "retries": 0}
    assert sorted(probe._libraries) == [5, 6]
    assert all(lib.device == torch.device("cpu")
               for lib in probe._libraries.values())
    assert a["throughput_mode"] == "wall"
    assert a["wall_tokens_per_s"] == a["tokens_per_s"] > 0


def test_probe_compiles_on_its_own_device():
    """A default Explorer on another device is not used: the probe makes
    one of the same configuration on its own device."""
    old = api.default_explorer()
    api.set_default_explorer(Explorer(dataclasses.replace(
        old.config, device="cuda")))
    try:
        probe = ServeProbe("modeled", device=CPU)
        ex = probe._session()
        assert ex is not api.default_explorer()
        assert ex.config.device == "cpu"
        assert ex.config.cache_dir == old.config.cache_dir
        probe.close()
    finally:
        api.set_default_explorer(old)
    probe = ServeProbe("modeled", device=CPU)
    assert probe._session() is api.default_explorer()


# ---------------------------------------------------------------- study9

def test_study9_replay_from_copy(tmp_path):
    """The committed study replays with zero trials executed, its frontier
    byte-equal to FRONTIER_10.json outside ``meta``; the committed files
    keep their bytes."""
    digests = _file_digests(STUDY9)
    root = _study9_copy(tmp_path)
    with Study(root, device=CPU) as study:
        records = study.run(max_trials=0)
        assert study.stats == {"executed": 0, "replayed": 120,
                               "infeasible": 0}
        assert study.probe.stats["runs"] == 0
        path = study.write_frontier(records)
        row = study.summary()
    fresh = load_frontier(path)
    committed = load_frontier(DSE / "FRONTIER_10.json")
    assert _without_meta(fresh) == _without_meta(committed)
    assert compare_frontiers(fresh, committed) == []
    assert row["trials_recorded"] == 120 and row["trials_total"] == 600
    assert fresh["meta"]["torch"] and "jax" not in fresh["meta"]
    assert _file_digests(STUDY9) == digests


@pytest.mark.parametrize("engine", ["batched", "pallas"])
def test_study9_prefix_fresh_equals_journal(tmp_path, engine):
    """The first 120 trials of the default space, run fresh: every record's
    status, metrics and objectives equal the committed journal's record
    of the same key (under ``pallas`` with the engine field aside), in the
    same order."""
    space = dataclasses.replace(default_space(), engines=(engine,))
    with Study(tmp_path / "p", space, measure="modeled",
               device=CPU) as study:
        records = study.run(max_trials=120)
        assert study.stats["executed"] == 120
        assert study.probe.stats["runs"] == 4
    want = _journal(STUDY9 / "journal.jsonl")
    got = [r.to_dict() for r in records.values()]
    assert len(got) == len(want) == 120
    for g, w in zip(got, want):
        assert g["params"] == {**w["params"], "engine": engine}
        for field in ("status", "metrics", "objectives", "schema"):
            assert g[field] == w[field], (w["key"], field)


def test_segment_preset_fresh_equals_frontier8(tmp_path):
    """48 trials, uniform and hier layouts, 6 of them infeasible: the
    frontier is FRONTIER_8.json's bytes outside ``meta``."""
    with Study(tmp_path / "s8", PRESETS["segment"](), measure="modeled",
               name="study8", device=CPU) as study:
        study.run()
        assert study.stats == {"executed": 48, "replayed": 0,
                               "infeasible": 6}
    fresh = load_frontier(tmp_path / "s8" / "frontier.json")
    assert _without_meta(fresh) == \
        _without_meta(load_frontier(DSE / "FRONTIER_8.json"))


# ---------------------------------------------------------------- across packages

def _ref_study(root, **kw):
    return rdse.Study(root, rdse.SearchSpace.from_dict(_space().to_dict()),
                      measure="none", name="t", **kw)


def _strip_timing(recs: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "timing"} for r in recs]


def test_reference_study_resumes_in_port(tmp_path):
    with _ref_study(tmp_path / "r") as ref:
        ref.run()
    before = load_frontier(tmp_path / "r" / "frontier.json")
    with Study(tmp_path / "r", device=CPU) as study:
        study.run()
        assert study.stats["executed"] == 0
        assert study.stats["replayed"] == N
    after = load_frontier(tmp_path / "r" / "frontier.json")
    assert _without_meta(after) == _without_meta(before)
    assert "torch" in after["meta"] and "jax" in before["meta"]


def test_port_study_resumes_in_reference(tmp_path):
    _run_full(tmp_path / "p")
    before = load_frontier(tmp_path / "p" / "frontier.json")
    with rdse.Study(tmp_path / "p") as ref:
        ref.run()
        assert ref.stats["executed"] == 0
        assert ref.stats["replayed"] == N
    after = load_frontier(tmp_path / "p" / "frontier.json")
    assert _without_meta(after) == _without_meta(before)


def test_journal_records_equal_reference(tmp_path):
    """Fresh runs of the same space in both packages journal the same
    records (outside ``timing``) and the same frontier outside ``meta``."""
    _run_full(tmp_path / "p")
    with _ref_study(tmp_path / "r") as ref:
        ref.run()
    assert _strip_timing(_journal(tmp_path / "p" / "journal.jsonl")) == \
        _strip_timing(_journal(tmp_path / "r" / "journal.jsonl"))
    assert _without_meta(load_frontier(tmp_path / "p" / "frontier.json")) \
        == _without_meta(load_frontier(tmp_path / "r" / "frontier.json"))


# ---------------------------------------------------------------- Remez

TABLE1 = [("recip", 10, {}), ("recip", 16, {}),
          ("log2", 10, {"out_bits": 11}), ("log2", 16, {"out_bits": 17}),
          ("exp2", 10, {"out_bits": 10}), ("exp2", 16, {"out_bits": 16})]


def _same_design(a, b) -> bool:
    da, db = a.to_dict(), b.to_dict()
    return json.dumps(da, sort_keys=True) == json.dumps(db, sort_keys=True)


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("r", [4, 6, 8])
@pytest.mark.parametrize("case", TABLE1, ids=lambda c: f"{c[0]}{c[1]}")
def test_remez_table_equals_reference(case, r, degree):
    """Table I's specs (``benchmarks/table1.py``): the same verdict, k,
    widths and coefficients as the reference's baseline."""
    from repro.core.funcspec import get_spec as rget_spec

    kind, bits, kw = case
    got = remez.generate_remez_table(get_spec(kind, bits, **kw), r,
                                     degree=degree)
    want = rremez.generate_remez_table(rget_spec(kind, bits, **kw), r,
                                       degree=degree)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.k, got.widths) == (want.k, want.widths)
        assert _same_design(got.design, want.design)


def test_remez_fit_equals_reference():
    rng = np.random.default_rng(0)
    xs = np.arange(64, dtype=np.float64)
    for degree in (1, 2):
        vals = np.cumsum(rng.normal(size=64))
        np.testing.assert_array_equal(remez.remez_fit(xs, vals, degree),
                                      rremez.remez_fit(xs, vals, degree))
        np.testing.assert_array_equal(
            remez._exact_fit(xs[:2], vals[:2], degree),
            rremez._exact_fit(xs[:2], vals[:2], degree))


# ---------------------------------------------------------------- the shims

def _rspec(kind, bits, **kw):
    from repro.core.funcspec import get_spec as rget_spec

    return rget_spec(kind, bits, **kw)


def _same_result(a, b) -> bool:
    return (_same_design(a.design, b.design) and a.area == b.area
            and a.delay == b.delay and a.report.k == b.report.k
            and a.report.degree == b.report.degree)


@pytest.mark.parametrize("kind,bits", [("recip", 8), ("exp2", 8)])
def test_generate_table_shim_equals_reference(kind, bits):
    got = generate.generate_table(get_spec(kind, bits))
    assert _same_result(got, rgen.generate_table(_rspec(kind, bits)))
    with Explorer(ExploreConfig(device=CPU)) as ex:
        best = ex.explore(get_spec(kind, bits), target="asic").best
    assert _same_design(got.design, best.design)
    assert got.area_delay == best.area * best.delay


def test_generate_table_fixed_r_infeasible_raises():
    with pytest.raises(ValueError, match="no feasible design"):
        generate.generate_table(get_spec("recip", 8), lookup_bits=0)


@pytest.mark.parametrize("kind,bits,r", [
    ("recip", 8, 4), ("recip", 10, 6), ("exp2", 8, 4), ("log2", 8, 4),
    ("sigmoid", 8, 4), ("silu", 8, 4), ("silu", 10, 5), ("recip", 10, 4),
])
def test_generate_for_r_equals_reference(kind, bits, r):
    spec = get_spec(kind, bits)
    got = generate.generate_for_r(spec, r)
    want = rgen.generate_for_r(_rspec(kind, bits), r)
    assert got is not None and want is not None
    assert _same_result(got, want)
    assert got.design.verify(spec)[0]


def test_widths_not_wider_than_remez():
    """Table II's qualitative claim on the port: complete-space a-width <=
    Remez a-width (tests/core/test_decision.py)."""
    spec = get_spec("recip", 10)
    ours = generate.generate_for_r(spec, 4)
    rz = remez.generate_remez_table(spec, 4, degree=2)
    assert ours is not None and rz is not None
    assert ours.design.lut_widths[0] <= rz.widths[0]
    assert sum(ours.design.lut_widths) <= sum(rz.widths) + 4


@pytest.mark.parametrize("kind,bits", [("recip", 8), ("exp2", 8),
                                       ("log2", 10)])
def test_sweep_lub_and_min_feasible_r_equal_reference(kind, bits):
    spec, rspec = get_spec(kind, bits), _rspec(kind, bits)
    assert generate.min_feasible_r(spec) == rgen.min_feasible_r(rspec)
    assert generate.min_feasible_r(spec, r_max=6) == \
        rgen.min_feasible_r(rspec, r_max=6)
    got = generate.sweep_lub(spec)
    want = rgen.sweep_lub(rspec)
    assert len(got) == len(want) > 0
    assert all(_same_result(a, b) for a, b in zip(got, want))
    got = generate.sweep_lub(spec, r_lo=5, r_hi=7)
    want = rgen.sweep_lub(rspec, r_lo=5, r_hi=7)
    assert [g.design.lookup_bits for g in got] == \
        [w.design.lookup_bits for w in want]
    assert all(_same_result(a, b) for a, b in zip(got, want))
