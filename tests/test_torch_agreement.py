"""Agreement across the ranks of a mesh, on the CPU: gloo processes, one
per rank (``test_torch_dist.py``'s launcher: a ``file://`` store, a hard
limit per launch, 60 s collective timeouts, so that ranks that part fail
their tests instead of stalling the suite).

The reference runs one controller on one clock and writes one journal; a
meshed port runs one process per rank. Held here, on 2 ranks at
``(data, tp)`` = (2, 1) and (1, 2):

* deadlines: each rank's ``FaultClock`` reads 1 s later than the rank
  before it, and a live request's, a queued request's and a submitted
  request's deadline fall between the two readings. Every rank rejects,
  expires and retires the same requests at the same tick (the agreed
  reading, the max over ranks), and the streams and the journal equal an
  unmeshed engine's on the clock the agreement picks (rank 1's);
* the journal: written once by the lead rank, sync and through the host
  pipeline, line for line the unmeshed engine's; cut after an emit and
  resumed on the mesh (where only the lead has the file) or without one,
  it completes the uninterrupted streams;
* a stop requested on one rank of a Trainer's mesh stops every rank after
  the same step, with one checkpoint of that step;
* the serve launcher on a 2-rank mesh writes its journal and saves its
  library once, from rank 0.
"""
from __future__ import annotations

import json

import pytest

from test_torch_dist import _launch, _result

SHAPES = ("2x1", "1x2")
MODES = ("sync", "async")


@pytest.fixture(scope="module")
def agree_run(tmp_path_factory):
    return _result(_launch(tmp_path_factory.mktemp("agree"), 2, """
    from repro_torch.faults import FaultClock
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.engine import Rejected
    from repro_torch.serve.journal import load_requests
    from repro_torch.train.step import StepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config("yi_6b")
    params = tf.init_params(cfg, 0, "cpu")
    prompts = prompts_for(cfg)
    # rank r's clock starts at r * OFF; after ADVANCE the readings are
    # (2, 3): LATE lies between them, as 0.5 lies between (0, 1) at submit
    OFF, ADVANCE, LATE = 1.0, 2.0, 2.5

    def lines(path):
        return (open(path).read().splitlines() if os.path.exists(path)
                else [])

    def gather(x):
        got = [None] * WORLD
        dist.all_gather_object(got, x)
        return got

    def deadline_run(clock, journal, mesh=None):
        eng = ServeEngine(cfg, params, slots=4, cache_len=48, horizon=2,
                          clock=clock, deadline_s=10.0, journal=journal,
                          mesh=mesh, device="cpu")
        events = []
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new=6,
                               deadline=LATE if i in (1, 5) else None))
        try:
            eng.submit(Request(6, prompts[0], max_new=6, deadline=0.5))
        except Rejected as e:
            events.append([6, e.reason, 0])
        seen = set()
        for t in range(60):
            if not (eng.queue or any(r is not None for r in eng.req)):
                break
            if t == 1:
                clock.advance(ADVANCE)
            eng.step(2)
            for r in eng.failed + eng.finished:
                if r.rid not in seen:
                    seen.add(r.rid)
                    events.append([r.rid, r.error or "done",
                                   eng.stats["ticks"]])
        eng.close()
        streams = {r.rid: list(r.out) for r in eng.finished + eng.failed}
        return events, streams, eng.stats.get("agreements")

    # the unmeshed engine on the clock the agreement picks: rank 1's
    ref_ev, ref_st, ref_agreements = deadline_run(
        FaultClock(OFF), f"{TMP}/dl_ref_{RANK}.jsonl")
    RES["deadline_ref"] = {"events": ref_ev, "agreements": ref_agreements}
    RES["deadline"] = {}
    for d, t in ((2, 1), (1, 2)):
        m = make_serve_mesh(d, t)
        path = f"{TMP}/dl_{d}x{t}.jsonl"
        ev, st, agreements = deadline_run(FaultClock(OFF * RANK), path,
                                          mesh=m)
        dist.barrier()
        RES["deadline"][f"{d}x{t}"] = {
            "events": gather(ev), "streams_equal": gather(st == ref_st),
            "journal_equal": lines(path) == lines(f"{TMP}/dl_ref_0.jsonl"),
            "journal_lines": len(lines(path)), "agreements": agreements}

    # the journal: one writer, and resume in both directions
    RES["journal"] = {}
    for mode in ("sync", "async"):
        kw = dict(aot_buckets=(8, 16), async_host=mode == "async")
        ref_path = f"{TMP}/j_ref_{mode}_{RANK}.jsonl"
        ref, _ = serve(cfg, params, prompts, journal=ref_path, **kw)
        for d, t in ((2, 1), (1, 2)):
            m = make_serve_mesh(d, t)
            path = f"{TMP}/j_{d}x{t}_{mode}.jsonl"
            got, eng = serve(cfg, params, prompts, journal=path, mesh=m,
                             **kw)
            dist.barrier()
            key = f"{d}x{t}_{mode}"
            res = {"streams_equal": got == ref,
                   "agreements": eng.stats.get("agreements"),
                   "lines": len(lines(path)),
                   "ref_lines": len(lines(ref_path)),
                   "equal": lines(path) == lines(ref_path)}
            # cut after the 6th emit: the lead alone holds the cut file
            cut = f"{TMP}/cut_{key}.jsonl"
            if RANK == 0:
                kept, n = [], 0
                for ln in lines(path):
                    kept.append(ln)
                    n += json.loads(ln)["ev"] == "emit"
                    if n == 6:
                        break
                open(cut, "w").write("\\n".join(kept) + "\\n")
                open(f"{cut}.single", "w").write("\\n".join(kept) + "\\n")
            mine = cut if RANK == 0 else f"{TMP}/absent_{key}.jsonl"
            eng = ServeEngine.resume(mine, cfg, params, slots=4,
                                     cache_len=48, device="cpu", mesh=m,
                                     **kw)
            eng.run()
            eng.close()
            dist.barrier()
            if RANK == 0:
                one = ServeEngine.resume(f"{cut}.single", cfg, params,
                                         slots=4, cache_len=48,
                                         device="cpu", **kw)
                one.run()
                one.close()
                for label, f in (("mesh", cut), ("single", f"{cut}.single")):
                    states = load_requests(f)
                    res[f"resumed_{label}"] = (
                        {rid: s.out for rid, s in states.items()} == ref
                        and all(s.done for s in states.values()))
            res["resumed"] = eng.stats["resumed"]
            res["absent_made"] = gather(os.path.exists(mine) and RANK > 0)
            RES["journal"][key] = res

    # a stop requested on rank 0 only, after step 2
    tc = TrainerConfig(steps=6, ckpt_dir=f"{TMP}/stop", ckpt_every=4,
                       log_every=100, seq_len=16, global_batch=4,
                       step=StepConfig(warmup=0))
    tr = Trainer(cfg, tc, mesh=make_host_mesh(2), device="cpu")
    if RANK == 0:
        inner = tr.step_fn

        def stop_after_2(state, batch, step):
            out = inner(state, batch, step)
            if step == 2:
                tr.request_stop()
            return out
        tr.step_fn = stop_after_2
    hist = tr.run()
    dist.barrier()
    RES["stop"] = {"steps": gather([h["step"] for h in hist]),
                   "ckpts": sorted(os.listdir(f"{TMP}/stop")),
                   "latest": open(f"{TMP}/stop/LATEST").read().strip()}
    done()
    """))


@pytest.mark.parametrize("shape", SHAPES)
def test_deadlines_agree_across_ranks(agree_run, shape):
    """Both ranks reject the request whose deadline falls between their
    submit readings, expire the live and the queued request whose deadline
    falls between their later readings, and retire every request at the
    same tick, as the unmeshed engine on rank 1's clock does."""
    got = agree_run["deadline"][shape]
    ref = agree_run["deadline_ref"]["events"]
    assert got["events"][0] == got["events"][1] == ref
    kinds = {(rid, err) for rid, err, _tick in ref}
    assert {(6, "deadline"), (1, "deadline_exceeded"),
            (5, "deadline_exceeded")} <= kinds
    assert sum(err == "done" for _rid, err, _tick in ref) == 4
    assert got["agreements"] > 0
    assert agree_run["deadline_ref"]["agreements"] == 0  # no mesh


@pytest.mark.parametrize("shape", SHAPES)
def test_deadline_streams_and_journal_equal_unmeshed(agree_run, shape):
    got = agree_run["deadline"][shape]
    assert got["streams_equal"] == [True, True]
    assert got["journal_equal"] and got["journal_lines"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_journal_is_written_once(agree_run, shape, mode):
    """The lead writes the meshed engine's journal alone: line for line
    the unmeshed engine's, each record once. With no deadline and no
    watchdog the engine issues no agreement."""
    got = agree_run["journal"][f"{shape}_{mode}"]
    assert got["streams_equal"]
    assert got["lines"] == got["ref_lines"] > 0
    assert got["equal"]
    assert got["agreements"] == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_cut_journal_resumes_on_the_mesh_and_off_it(agree_run, shape, mode):
    """The journal cut after its 6th emit, resumed on the mesh (rank 1
    names a file that does not exist: only the lead reads) and resumed
    without a mesh, completes every request with the uninterrupted
    streams."""
    got = agree_run["journal"][f"{shape}_{mode}"]
    assert got["resumed"] > 0
    assert got["resumed_mesh"] and got["resumed_single"]
    assert got["absent_made"] == [False, False]


def test_stop_on_one_rank_stops_every_rank(agree_run):
    """``request_stop()`` on rank 0 after step 2: both ranks run steps
    0-2 and stop; the checkpoints are step 0's (``ckpt_every``) and the
    forced one of step 2, once."""
    got = agree_run["stop"]
    assert got["steps"] == [[0, 1, 2], [0, 1, 2]]
    assert got["ckpts"] == ["LATEST", "step_000000000", "step_000000002"]
    assert got["latest"] == "2"


def test_serve_cli_mesh_writes_journal_and_library_once(tmp_path, capsys):
    """``launch/serve.py --mesh 2x1 --journal J --save-library L``: the
    journal equals the unmeshed launcher's line for line, and only rank 0
    calls ``InterpLibrary.save``."""
    from repro_torch.launch import serve

    common = ["--arch", "yi_6b", "--smoke", "--device", "cpu",
              "--numerics", "interp", "--requests", "3", "--max-new", "4",
              "--aot-buckets", "8,16"]
    serve.main([*common, "--journal", str(tmp_path / "single.jsonl")])
    capsys.readouterr()
    lib, journal = tmp_path / "mesh" / "lib", tmp_path / "mesh.jsonl"
    body = f"""
    import os, runpy, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.api.library import InterpLibrary
    real = InterpLibrary.save

    def save(self, path, *a, **k):
        open(f"{{path}}.saved_by_{{os.environ['RANK']}}", "w").close()
        return real(self, path, *a, **k)
    InterpLibrary.save = save
    sys.argv = ["repro_torch.launch.serve"] + sys.argv[1:]
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    """
    (tmp_path / "mesh").mkdir()
    outs = _launch(tmp_path / "mesh", 2, body, prelude=False, argv=[
        *common, "--mesh", "2x1", "--journal", str(journal),
        "--save-library", str(lib),
        "--dist-url", f"file://{tmp_path}/mesh/store"])
    last = json.loads(outs[0].strip().splitlines()[-1])
    assert last["mesh"] == "2x1" and last["tokens"] == 12
    assert sorted(p.name for p in lib.parent.glob("lib.saved_by_*")) == [
        "lib.saved_by_0"]
    single = (tmp_path / "single.jsonl").read_text().splitlines()
    assert journal.read_text().splitlines() == single and single
