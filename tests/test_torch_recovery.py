"""Crash-recoverable serving in the port: twins of
``tests/serve/test_recovery.py`` and ``tests/util/test_journal.py``, and
journals handed between the two packages.

* The journal primitives (``repro_torch.util.journal``) on the reference's
  cases, and byte for byte the reference's records.
* A kill-9 at any crash point (``Crashed`` raised between two durability
  events), then ``ServeEngine.resume`` and a run to the end: every request
  ends with the stream of an uninterrupted run, bitwise; completed work is
  skipped, the durable prefix only teacher-forced.
* A journal written by the reference's engine resumes in the port's, and
  the port's in the reference's, to the uninterrupted streams: on exact
  numerics the two packages decode the ``yi_6b`` smoke config's tokens
  bitwise alike (``tests/test_torch_faults.py``).
* The serve CLI's robustness flags parse to the reference's values, and a
  journaled CLI run resumes.
"""
from __future__ import annotations

import argparse
import json

import jax
import numpy as np
import pytest
import torch

import repro.faults as jfaults
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.serve import journal as jjournal
from repro.util import journal as jutil
from repro_torch import faults
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.faults import Crashed, arm_crashpoint, reset_crashpoints
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.journal import (ServeJournal, ServeJournalCorrupt,
                                       load_requests)
from repro_torch.util.journal import (JournalCorrupt, JournalWriter,
                                      atomic_write_bytes, atomic_write_text,
                                      read_journal, trim_torn_tail)

MAX_NEW = 7
LENGTHS = (5, 11, 3)
POINTS = [("serve.submit.journaled", 1), ("serve.admit.emitted", 1),
          ("serve.tick.emitted", 1), ("serve.retire.journaled", 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_crashpoints():
    reset_crashpoints()
    jfaults.reset_crashpoints()
    yield
    reset_crashpoints()
    jfaults.reset_crashpoints()


@pytest.fixture(scope="module")
def model():
    """(port cfg, port params, reference cfg, reference params)."""
    jcfg = jax_smoke_config("yi_6b")
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    cfg = get_smoke_config("yi_6b")
    return (cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu"), jcfg, jparams)


def _prompts(cfg, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in LENGTHS]


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, params, slots=2, cache_len=48, device="cpu", **kw)


def _reference(cfg, params, **kw):
    eng = _engine(cfg, params, **kw)
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(Request(i, p, max_new=MAX_NEW))
    return {r.rid: r.out for r in eng.run()}


def _crash_and_resume(cfg, params, journal, point, after, **kw):
    """Run journaled until ``point`` fires, then resume and finish."""
    eng = _engine(cfg, params, journal=str(journal), **kw)
    arm_crashpoint(point, after=after)
    with pytest.raises(Crashed):
        for i, p in enumerate(_prompts(cfg)):
            eng.submit(Request(i, p, max_new=MAX_NEW))
        eng.run()
    reset_crashpoints()
    pre = load_requests(journal)
    res = ServeEngine.resume(str(journal), cfg, params, slots=2,
                             cache_len=48, device="cpu", **kw)
    res.run()
    return pre, res


# ------------------------------------------------------ journal primitives

def test_atomic_write_leaves_no_tmp(tmp_path):
    p = tmp_path / "a" / "doc.json"
    atomic_write_text(p, json.dumps({"x": 1}))
    assert json.loads(p.read_text()) == {"x": 1}
    assert not list(p.parent.glob("*.tmp"))
    atomic_write_bytes(p, b"raw")
    assert p.read_bytes() == b"raw"


def test_writer_appends_are_replayable(tmp_path):
    p = tmp_path / "j.jsonl"
    with JournalWriter(p) as w:
        w.append({"i": 0})
        w.append({"i": 1})
    with JournalWriter(p) as w:
        w.append({"i": 2})
    records, dropped = read_journal(p)
    assert [r["i"] for r in records] == [0, 1, 2]
    assert dropped == 0


def test_torn_tail_dropped_and_truncated(tmp_path):
    p = tmp_path / "j.jsonl"
    with JournalWriter(p) as w:
        w.append({"i": 0})
    with open(p, "a") as f:
        f.write('{"i": 1, "par')
    records, dropped = read_journal(p)
    assert [r["i"] for r in records] == [0] and dropped == 1
    with JournalWriter(p) as w:
        w.append({"i": 2})
    records, dropped = read_journal(p)
    assert [r["i"] for r in records] == [0, 2] and dropped == 0


def test_unterminated_complete_record_is_terminated_not_lost(tmp_path):
    p = tmp_path / "j.jsonl"
    with JournalWriter(p) as w:
        w.append({"i": 0})
        w.append({"i": 1})
    p.write_bytes(p.read_bytes()[:-1])
    trim_torn_tail(p)
    records, dropped = read_journal(p)
    assert [r["i"] for r in records] == [0, 1] and dropped == 0


def test_mid_file_corruption_raises(tmp_path):
    p = tmp_path / "j.jsonl"
    with JournalWriter(p) as w:
        for i in range(3):
            w.append({"i": i})
    lines = p.read_text().splitlines()
    lines[0] = lines[0][:5]
    p.write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalCorrupt):
        read_journal(p)

    class Custom(JournalCorrupt):
        pass

    with pytest.raises(Custom):
        read_journal(p, corrupt=Custom)
    with pytest.raises(ServeJournalCorrupt):
        load_requests(p)


def test_read_missing_journal_is_empty(tmp_path):
    assert read_journal(tmp_path / "absent.jsonl") == ([], 0)


def test_journal_records_are_the_reference_bytes(tmp_path):
    """The same events through both packages' writers: identical files."""
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    for mod, name in ((jjournal, "ref"), (None, "port")):
        j = (mod.ServeJournal if mod else ServeJournal)(tmp_path / name)
        j.submit(7, prompt, 12, None)
        j.submit(8, prompt[:2], 3, 12.5)
        j.emit(7, [17, 4])
        j.emit(7, [])
        j.fail(8, "deadline_exceeded")
        j.done(7)
        j.close()
    assert (tmp_path / "ref").read_bytes() == (tmp_path / "port").read_bytes()
    for mod in (jutil, None):
        w = (mod.JournalWriter if mod else JournalWriter)(tmp_path / "w")
        w.append({"b": 1, "a": [1.5, None]})
        w.close()
    assert read_journal(tmp_path / "w") == jutil.read_journal(tmp_path / "w")
    states = load_requests(tmp_path / "port")
    jstates = jjournal.load_requests(tmp_path / "port")
    assert list(states) == list(jstates) == [7, 8]
    for rid in states:
        a, b = states[rid], jstates[rid]
        assert (a.out, a.done, a.error, a.max_new, a.deadline,
                a.in_flight) == (b.out, b.done, b.error, b.max_new,
                                 b.deadline, b.in_flight)
        np.testing.assert_array_equal(a.prompt, b.prompt)


# ---------------------------------------------------------------- recovery

def test_journaled_run_reaches_done_states(model, tmp_path):
    cfg, params = model[:2]
    jp = tmp_path / "serve.jsonl"
    eng = _engine(cfg, params, journal=str(jp))
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(Request(i, p, max_new=MAX_NEW))
    done = {r.rid: r.out for r in eng.run()}
    states = load_requests(jp)
    assert set(states) == set(done)
    for rid, st in states.items():
        assert st.done and st.error is None and st.out == done[rid]


@pytest.mark.parametrize("point,after", POINTS)
def test_crash_anywhere_resumes_to_identical_streams(model, tmp_path, point,
                                                     after):
    cfg, params = model[:2]
    want = _reference(cfg, params)
    jp = tmp_path / "serve.jsonl"
    pre, res = _crash_and_resume(cfg, params, jp, point, after)
    final = load_requests(jp)
    assert set(final) == set(pre)
    assert {rid: st.out for rid, st in final.items()} == {
        rid: want[rid] for rid in final}
    assert all(st.done for st in final.values())
    n_done_pre = sum(1 for st in pre.values() if not st.in_flight
                     or len(st.out) >= st.max_new)
    assert res.stats["resume_skipped_done"] == n_done_pre
    want_replay = sum(max(0, len(st.out) - 1) for st in pre.values()
                      if st.in_flight and len(st.out) < st.max_new)
    assert res.stats["resume_replay_steps"] == want_replay


def test_mid_stream_crash_suffix_is_bitwise(model, tmp_path):
    cfg, params = model[:2]
    want = _reference(cfg, params)
    jp = tmp_path / "serve.jsonl"
    pre, res = _crash_and_resume(cfg, params, jp, "serve.tick.emitted", 2,
                                 horizon=1)
    partial = {rid: st for rid, st in pre.items() if st.in_flight
               and 0 < len(st.out) < st.max_new}
    assert partial, "crash landed at a stream boundary; tune `after`"
    final = load_requests(jp)
    for rid, st in partial.items():
        assert want[rid][:len(st.out)] == st.out
        assert final[rid].out == want[rid]
        assert len(final[rid].out) > len(st.out)
    assert res.stats["resumed"] == len(partial)


def test_resume_replays_nothing_when_all_done(model, tmp_path):
    cfg, params = model[:2]
    jp = tmp_path / "serve.jsonl"
    eng = _engine(cfg, params, journal=str(jp))
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(Request(i, p, max_new=MAX_NEW))
    eng.run()
    res = ServeEngine.resume(str(jp), cfg, params, slots=2, cache_len=48,
                             device="cpu")
    assert res.stats["resume_skipped_done"] == len(LENGTHS)
    assert res.stats["resume_replay_steps"] == 0
    res.run()
    assert res.stats["decode_steps"] == 0


def test_resume_drops_torn_tail_and_regenerates(model, tmp_path):
    cfg, params = model[:2]
    want = _reference(cfg, params)
    jp = tmp_path / "serve.jsonl"
    _crash_and_resume(cfg, params, jp, "serve.tick.emitted", 1)
    with open(jp, "a") as f:
        f.write('{"ev": "emit", "rid": 0, "to')
    res = ServeEngine.resume(str(jp), cfg, params, slots=2, cache_len=48,
                             device="cpu")
    res.run()
    assert {rid: st.out for rid, st in load_requests(jp).items()} == want


@pytest.mark.parametrize("fused", [True, False])
def test_interp_engine_recovers_bitwise(model, tmp_path, fused):
    """The rebuild runs the numerics the engine decoded with (the fused
    lowering on the fused engine, the unfused one on the serial path)."""
    cfg, params = model[:2]
    cfg = cfg.replace(numerics="interp")
    want = _reference(cfg, params, fused=fused)
    jp = tmp_path / "serve.jsonl"
    _pre, res = _crash_and_resume(cfg, params, jp, "serve.tick.emitted", 1,
                                  fused=fused, horizon=2)
    final = load_requests(jp)
    assert {rid: st.out for rid, st in final.items()} == want
    assert all(st.done for st in final.values())
    assert res.stats["resume_replay_steps"] > 0


def test_replay_decodes_the_whole_pool_in_place(model, tmp_path):
    """The teacher-forced rebuild decodes at the pool's batch size into the
    pool itself, and counts its launches and prefills."""
    cfg, params = model[:2]
    jp = tmp_path / "serve.jsonl"
    pre, res = _crash_and_resume(cfg, params, jp, "serve.tick.emitted", 1,
                                 horizon=2)
    partial = sum(1 for st in pre.values() if st.in_flight
                  and 0 < len(st.out) < st.max_new)
    assert res.stats["resumed"] == partial > 0
    assert res.stats["prefills"] == len(pre) - res.stats[
        "resume_skipped_done"]


# ------------------------------------------------- between the two packages

def _journal_run_reference(jcfg, jparams, jp, point, after):
    eng = jengine.ServeEngine(jcfg, jparams, slots=2, cache_len=48,
                              journal=str(jp))
    jfaults.arm_crashpoint(point, after=after)
    with pytest.raises(jfaults.Crashed):
        for i, p in enumerate(_prompts(jcfg)):
            eng.submit(jengine.Request(i, p, max_new=MAX_NEW))
        eng.run()
    jfaults.reset_crashpoints()


@pytest.mark.parametrize("point,after", POINTS[1:3])
def test_reference_journal_resumes_in_the_port(model, tmp_path, point,
                                               after):
    cfg, params, jcfg, jparams = model
    want = _reference(cfg, params)
    jp = tmp_path / "serve.jsonl"
    _journal_run_reference(jcfg, jparams, jp, point, after)
    pre = load_requests(jp)
    assert any(st.in_flight for st in pre.values())
    res = ServeEngine.resume(str(jp), cfg, params, slots=2, cache_len=48,
                             device="cpu")
    res.run()
    final = jjournal.load_requests(jp)
    assert {rid: st.out for rid, st in final.items()} == {
        rid: want[rid] for rid in final}
    assert all(st.done for st in final.values())


@pytest.mark.parametrize("point,after", POINTS[1:3])
def test_port_journal_resumes_in_the_reference(model, tmp_path, point,
                                               after):
    cfg, params, jcfg, jparams = model
    want = _reference(cfg, params)
    jp = tmp_path / "serve.jsonl"
    eng = _engine(cfg, params, journal=str(jp))
    arm_crashpoint(point, after=after)
    with pytest.raises(Crashed):
        for i, p in enumerate(_prompts(cfg)):
            eng.submit(Request(i, p, max_new=MAX_NEW))
        eng.run()
    reset_crashpoints()
    res = jengine.ServeEngine.resume(str(jp), jcfg, jparams, slots=2,
                                     cache_len=48)
    res.run()
    final = load_requests(jp)
    assert {rid: st.out for rid, st in final.items()} == {
        rid: want[rid] for rid in final}
    assert all(st.done for st in final.values())


# ---------------------------------------------------------------- the CLI

class _Parsed(Exception):
    pass


@pytest.fixture(scope="module")
def reference_parser():
    """The reference launcher's parser, caught as its ``main()`` parses."""
    from repro.launch import serve as jserve

    caught = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, *args, **kwargs):
        caught["ap"] = self
        raise _Parsed

    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(_Parsed):
            jserve.main()
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["ap"]


ROBUST = ("serial", "horizon", "deadline_ms", "max_queue", "journal",
          "resume")


@pytest.mark.parametrize("extra", [
    [], ["--serial"], ["--deadline-ms", "250"], ["--max-queue", "3"],
    ["--journal", "j.jsonl", "--resume"], ["--horizon", "4"]])
def test_robustness_flags_parse_as_reference(extra, reference_parser):
    argv = ["--arch", "yi_6b", "--smoke", *extra]
    got = vars(tserve.build_parser().parse_args(argv))
    want = vars(reference_parser.parse_args(argv))
    assert {k: got[k] for k in ROBUST} == {k: want[k] for k in ROBUST}
    assert got["eager"] is False


def test_cli_journal_and_resume(tmp_path, capsys):
    jp = str(tmp_path / "cli.jsonl")
    base = ["--arch", "yi_6b", "--smoke", "--device", "cpu", "--requests",
            "2", "--max-new", "3", "--journal", jp]
    tserve.main(base + ["--eager"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["tokens"] == 6 and first["stats"]["graph"] is False
    states = load_requests(jp)
    assert len(states) == 2 and all(st.done for st in states.values())
    tserve.main(base + ["--resume"])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["stats"]["resume_skipped_done"] == 2
    assert again["stats"]["decode_steps"] == 0
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "yi_6b", "--smoke", "--device", "cpu",
                     "--resume"])


def test_cli_serial_and_deadline(capsys):
    tserve.main(["--arch", "yi_6b", "--smoke", "--device", "cpu",
                 "--requests", "2", "--max-new", "3", "--serial"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tokens"] == 6
    assert out["stats"]["dispatches"] == 2 * out["stats"]["decode_steps"]
    tserve.main(["--arch", "yi_6b", "--smoke", "--device", "cpu",
                 "--requests", "2", "--max-new", "3", "--max-queue", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "request 1 rejected (queue_full)" in lines
    assert json.loads(lines[-1])["stats"]["rejected"] == 1


def test_faults_package_exports_the_reference_names():
    public = {n for n in dir(jfaults) if not n.startswith("_")}
    assert public - {"inject"} <= set(dir(faults))
    assert faults.crashpoints_armed() == {}
    arm_crashpoint("x", after=1)
    assert faults.crashpoints_armed() == {"x": 1}
    faults.crashpoint("x")
    with pytest.raises(Crashed):
        faults.crashpoint("x")
