"""The port's async host pipeline (``repro_torch.serve.pipeline``) against
the reference's (``tests/serve/test_pipeline.py``), on the ``yi_6b`` smoke
config with the reference's parameters and exact numerics (streams bitwise
between the packages, as ``tests/test_torch_faults.py`` holds them).

Held: async tokens equal the synchronous engine's (with and without AOT
buckets) and the reference's async engine's; an async engine's journal
holds the synchronous one's durable streams and resumes in either package
(a port journal in the reference and the reverse, crashed mid-run too);
worker errors surface on the main thread; the bounded queue holds
producers back; ``close`` is idempotent and refuses work after; the
watchdog still retires poisoned slots with the sentinel read on the main
thread; degrading to serial closes the pipeline. On the CPU the worker
copies a CPU block on the spot; the pinned ring and its events are held on
the card (``tests/test_torch_gpu.py``).
"""
from __future__ import annotations

import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.faults as jfaults
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.serve.journal import load_requests as jload_requests
from repro_torch import faults
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.journal import load_requests
from repro_torch.serve.pipeline import HostPipeline

MAX_NEW = 6
CACHE = 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_crashpoints():
    faults.reset_crashpoints()
    jfaults.reset_crashpoints()
    yield
    faults.reset_crashpoints()
    jfaults.reset_crashpoints()


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jax_smoke_config("yi_6b")
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    cfg = get_smoke_config("yi_6b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 3, 16, 9, 2)]
    return jcfg, jparams, cfg, params, prompts


def _serve(prompts=None, **kw):
    _, _, cfg, params, default = _setup()
    eng = ServeEngine(cfg, params, slots=3, cache_len=CACHE, device="cpu",
                      **kw)
    for i, p in enumerate(default if prompts is None else prompts):
        eng.submit(Request(i, p, max_new=MAX_NEW))
    out = {r.rid: list(r.out) for r in eng.run()}
    eng.close()
    return out, eng


def _serve_ref(**kw):
    jcfg, jparams, _, _, prompts = _setup()
    eng = jengine.ServeEngine(jcfg, jparams, slots=3, cache_len=CACHE, **kw)
    for i, p in enumerate(prompts):
        eng.submit(jengine.Request(i, p, max_new=MAX_NEW))
    out = {r.rid: list(r.out) for r in eng.run()}
    eng.close()
    return out, eng


STAT_KEYS = ("dispatches", "transfers", "ticks", "decode_steps",
             "async_chunks", "async_tokens", "admit_dispatches",
             "packed_admits", "packed_requests", "aot_hits", "aot_misses")


@pytest.mark.parametrize("aot_buckets", [None, (8, 16)])
def test_async_tokens_match_sync_and_the_reference(aot_buckets):
    ref, _ = _serve(aot_buckets=aot_buckets)
    got, eng = _serve(async_host=True, aot_buckets=aot_buckets)
    assert got == ref
    assert eng.stats["async_tokens"] > 0
    assert eng.pipeline is None  # close() tore it down
    want, jeng = _serve_ref(async_host=True, aot_buckets=aot_buckets)
    assert got == want
    assert {k: eng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    if aot_buckets is not None:
        assert eng.stats["aot_misses"] == 0


def test_async_journal_replays_like_sync(tmp_path):
    """The worker carries every journal write in queue order: an async
    engine's journal holds the synchronous one's durable streams, all done,
    and a resume replays nothing."""
    _, _, cfg, params, prompts = _setup()
    sj, aj = str(tmp_path / "sync.jnl"), str(tmp_path / "async.jnl")
    ref, _ = _serve(journal=sj)
    got, _ = _serve(journal=aj, async_host=True)
    assert got == ref
    sync_states, async_states = load_requests(sj), load_requests(aj)
    assert set(sync_states) == set(async_states)
    for rid, st in sync_states.items():
        assert async_states[rid].out == st.out
        assert async_states[rid].in_flight == st.in_flight
    res = ServeEngine.resume(aj, cfg, params, slots=3, cache_len=CACHE,
                             device="cpu")
    assert res.stats["resume_skipped_done"] == len(prompts)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_async_journal_resumes_in_the_other_package(writer, tmp_path):
    """A journal written by an async engine of either package, stopped
    mid-run after three ticks (three requests done, three in flight with
    part of their streams durable), resumes in the other package's engine
    to the uninterrupted streams (bitwise, exact numerics)."""
    jcfg, jparams, cfg, params, prompts = _setup()
    want, _ = _serve()
    jp = str(tmp_path / "serve.jnl")
    if writer == "port":
        eng = ServeEngine(cfg, params, slots=3, cache_len=CACHE,
                          device="cpu", journal=jp, async_host=True)
        req = Request
    else:
        eng = jengine.ServeEngine(jcfg, jparams, slots=3, cache_len=CACHE,
                                  journal=jp, async_host=True)
        req = jengine.Request
    for i, p in enumerate(prompts):
        eng.submit(req(i, p, max_new=MAX_NEW))
    for _ in range(3):  # stop mid-run: drain, drop the engine
        eng.step(eng.horizon)
    eng.close()
    states = (load_requests if writer == "port" else jload_requests)(jp)
    assert any(st.in_flight and st.out for st in states.values())
    if writer == "port":
        res = jengine.ServeEngine.resume(jp, jcfg, jparams, slots=3,
                                         cache_len=CACHE)
    else:
        res = ServeEngine.resume(jp, cfg, params, slots=3, cache_len=CACHE,
                                 device="cpu", async_host=True)
    res.run()
    res.close()
    final = {rid: st.out for rid, st in
             (jload_requests if writer == "port" else load_requests)(
                 jp).items()}
    assert final == want
    assert res.stats["resumed"] > 0


def test_async_requires_fused():
    _, _, cfg, params, _ = _setup()
    with pytest.raises(ValueError, match="fused"):
        ServeEngine(cfg, params, slots=2, cache_len=CACHE, fused=False,
                    async_host=True, device="cpu")


def test_async_watchdog_still_fails_poisoned_slots():
    """The sentinel download stays on the tick path: a NaN fault trips the
    watchdog with async bookkeeping on, and the poisoned chunk is never
    handed to the worker (no garbage tokens), as in the reference."""
    jcfg, jparams, cfg, params, prompts = _setup()
    engines = {}
    for name in ("port", "ref"):
        if name == "port":
            eng = ServeEngine(cfg, params, slots=2, cache_len=CACHE,
                              async_host=True, watchdog_limit=100,
                              device="cpu")
            inj = faults.TickFaultInjector("nan", every_n=1, limit=1)
            req = Request
        else:
            eng = jengine.ServeEngine(jcfg, jparams, slots=2,
                                      cache_len=CACHE, async_host=True,
                                      watchdog_limit=100)
            inj = jfaults.TickFaultInjector("nan", every_n=1, limit=1)
            req = jengine.Request
        inj.install(eng)
        for i, p in enumerate(prompts[:2]):
            eng.submit(req(i, p, max_new=MAX_NEW))
        eng.run()
        eng.close()
        assert inj.injected == 1
        engines[name] = eng
    eng = engines["port"]
    assert eng.stats["watchdog_trips"] == 1
    assert len(eng.failed) == 2
    for r in eng.failed:
        assert r.error == "non_finite_output"
        assert len(r.out) == 1  # admission token only, no garbage chunk
    assert eng.faults == engines["ref"].faults
    assert [r.out for r in eng.failed] == \
        [r.out for r in engines["ref"].failed]


def test_degrade_to_serial_closes_pipeline():
    """The serial rung has no fused tick for the worker to trail: the
    ladder drains and drops the pipeline first, and the engine finishes
    the surviving requests synchronously, as the reference's."""
    _, _, cfg, params, prompts = _setup()
    eng = ServeEngine(cfg, params, slots=1, cache_len=CACHE, device="cpu",
                      async_host=True, watchdog_limit=2)
    faults.TickFaultInjector("nan", every_n=1, limit=2).install(eng)
    for i, p in enumerate(prompts[:4]):
        eng.submit(Request(i, p, max_new=3))
    eng.run()
    assert eng.stats["degradations"] == 1
    assert eng.fused is False
    assert eng.pipeline is None
    assert len(eng.finished) == 2
    assert all(len(r.out) == 3 for r in eng.finished)
    jcfg, jparams, _, _, _ = _setup()
    jeng = jengine.ServeEngine(jcfg, jparams, slots=1, cache_len=CACHE,
                               async_host=True, watchdog_limit=2)
    jfaults.TickFaultInjector("nan", every_n=1, limit=2).install(jeng)
    for i, p in enumerate(prompts[:4]):
        jeng.submit(jengine.Request(i, p, max_new=3))
    jeng.run()
    assert {r.rid: r.out for r in eng.finished} == \
        {r.rid: r.out for r in jeng.finished}
    assert eng.faults == jeng.faults


def test_degrade_mid_stream_keeps_the_serial_token_mirror():
    """A live slot carried over from the async fused rung to the serial
    rung continues from its last streamed token (the host mirror is taken
    from the stream when the pipeline closes): the same tokens as a
    synchronous engine degraded at the same point."""
    _, _, cfg, params, prompts = _setup()
    outs = []
    for async_host in (False, True):
        eng = ServeEngine(cfg, params, slots=2, cache_len=CACHE,
                          device="cpu", async_host=async_host)
        for i, p in enumerate(prompts[:2]):
            eng.submit(Request(i, p, max_new=10))
        eng.step(2)
        eng._degrade("test")
        assert eng.pipeline is None and not eng.fused
        outs.append({r.rid: r.out for r in eng.run()})
    assert outs[0] == outs[1]


def test_pipeline_surfaces_worker_errors():
    class BoomJournal:
        def emit(self, rid, toks):
            raise RuntimeError("disk full")

    pipe = HostPipeline(journal=BoomJournal())
    req = Request(0, np.zeros(1, np.int32), max_new=4)
    pipe.emit_admit(((0, req),), np.asarray([7], np.int32))
    with pytest.raises(RuntimeError, match="disk full"):
        pipe.flush()
    pipe.close()


def test_pipeline_close_is_idempotent_and_rejects_after():
    pipe = HostPipeline()
    pipe.close()
    pipe.close()
    req = Request(0, np.zeros(1, np.int32), max_new=1)
    with pytest.raises(RuntimeError, match="closed"):
        pipe.emit_admit(((0, req),), np.asarray([1], np.int32))


def test_pipeline_backpressure_bounded_queue():
    """Past ``depth`` queued items ``put`` blocks (the producer waits for
    the worker) instead of growing the queue."""
    gate = threading.Event()

    class SlowJournal:
        def emit(self, rid, toks):
            gate.wait()

    pipe = HostPipeline(journal=SlowJournal(), depth=2)
    req = Request(0, np.zeros(1, np.int32), max_new=64)
    done = threading.Event()

    def produce():
        for _ in range(16):
            pipe.emit_admit(((0, req),), np.asarray([1], np.int32))
        done.set()

    t = threading.Thread(target=produce)
    t.start()
    time.sleep(0.3)
    assert not done.is_set()  # blocked behind the bounded queue
    assert pipe.depth <= 2
    gate.set()
    t.join(timeout=30)
    pipe.flush()
    assert done.is_set() and len(req.out) == 16
    assert pipe.drain_stats()["tokens"] == 16
    pipe.close()


def test_pipeline_copies_a_cpu_block_before_it_is_reused():
    """The engine's token block is reused by the next tick: the pipeline
    takes its copy at hand-off, so a block overwritten right after
    ``emit_chunk`` still streams the tokens it held."""
    pipe = HostPipeline(depth=4)
    req = Request(0, np.zeros(1, np.int32), max_new=8)
    block = torch.tensor([[5], [6]], dtype=torch.int64)
    pipe.emit_chunk(((0, req),), block)
    block.fill_(-1)
    pipe.flush()
    assert req.out == [5, 6]
    pipe.close()
