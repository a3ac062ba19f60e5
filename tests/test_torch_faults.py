"""The port's serving-robustness layer and fused tick against the
reference's: twins of ``tests/serve/test_faults.py`` and
``tests/serve/test_fused_engine.py`` on the ``yi_6b`` smoke config (and
``deepseek_moe_16b`` where the reference test takes a second arch).

Every scenario runs on both engines with the same parameters (the
reference's, converted), the same library, the same requests and the same
seeded fault schedule (``TickFaultInjector``, ``FaultClock``,
``flip_rom_bit`` from each package). Held equal between the two: the fault
logs (tick, reason, detail, action), every ``stats`` key of the reference
(the port's own keys beside them), the failed requests' errors, and the
token streams: bitwise on exact numerics; on interp numerics tie-aware, as
``tests/test_torch_engine.py`` (at a first divergence the reference's own
logits, recomputed by an exact-length prefill, show a top-2 gap inside
2 * 4 * 2^-12 * max|logit|). On the CPU the port's fused tick is its eager
loop; the CUDA graph replay is held against it on the card
(``tests/test_torch_gpu.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.faults as jfaults
from repro.api import LibraryIntegrityError as JaxIntegrityError
from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.serve import engine as jengine
from repro_torch import faults
from repro_torch.api.library import InterpLibrary, LibraryIntegrityError
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.numerics.guard import GuardedNumerics
from repro_torch.serve import engine

MAX_NEW = 5


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


@dataclasses.dataclass
class Kit:
    """One package's engine, its fault tools, and the model they serve."""

    port: bool
    cfg: object
    params: dict
    lib: object
    mod: object  # the engine module
    flt: object  # the faults package

    def engine(self, numerics: str | None = None, library="default", **kw):
        cfg = self.cfg if numerics is None else self.cfg.replace(
            numerics=numerics)
        if library == "default":
            library = self.lib if cfg.numerics != "exact" else None
        if self.port:
            kw.setdefault("device", "cpu")
        return self.mod.ServeEngine(cfg, self.params, library=library, **kw)

    def request(self, *a, **kw):
        return self.mod.Request(*a, **kw)


@functools.lru_cache(maxsize=None)
def _kits(arch: str) -> dict:
    jcfg = jax_smoke_config(arch)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_smoke_config(arch), "cpu")
    return {"ref": Kit(False, jcfg, jparams, default_explorer().compile(),
                       jengine, jfaults),
            "port": Kit(True, get_smoke_config(arch), params,
                        InterpLibrary.default_library("cpu"), engine, faults)}


@pytest.fixture(scope="module")
def kits():
    return _kits("yi_6b")


def _prompts(cfg, lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _streams(eng) -> dict:
    return {r.rid: list(r.out) for r in eng.finished + eng.failed}


def _check_streams(kits, ref, port, numerics: str) -> None:
    """Bitwise on exact numerics; tie-aware on interp numerics."""
    a, b = _streams(ref), _streams(port)
    assert set(a) == set(b)
    if numerics == "exact":
        assert a == b
        return
    k = kits["ref"]
    jcfg = k.cfg.replace(numerics="interp")
    jpre = jax.jit(functools.partial(
        jtf.prefill, cfg=jcfg, cache_len=64,
        numerics=jax_get_numerics(jcfg, k.lib, fused=True)))
    prompts = {r.rid: r.prompt for r in ref.finished + ref.failed}
    for rid in a:
        t = next((i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                  if x != y), None)
        if t is None:
            assert len(a[rid]) == len(b[rid])
            continue
        seq = np.concatenate([prompts[rid], np.asarray(a[rid][:t], np.int32)])
        logits = np.asarray(jpre(k.params, jnp.asarray(seq[None]))[0])[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= 2 * 4 * 2.0 ** -12 * np.abs(logits).max()


def _same(kits, ref, port, numerics="exact") -> None:
    """The fault logs, the reference's stats, errors and streams agree."""
    assert port.faults == ref.faults
    missing = set(ref.stats) - set(port.stats)
    assert not missing, missing
    assert {k: port.stats[k] for k in ref.stats} == ref.stats
    assert sorted((r.rid, r.error) for r in port.failed) == \
        sorted((r.rid, r.error) for r in ref.failed)
    assert sorted(r.rid for r in port.finished) == \
        sorted(r.rid for r in ref.finished)
    _check_streams(kits, ref, port, numerics)


def _both(kits, scenario, numerics="exact"):
    ref, port = scenario(kits["ref"]), scenario(kits["port"])
    _same(kits, ref, port, numerics)
    return ref, port


# ------------------------------------------------------------ admission

def test_queue_full_rejection(kits):
    def run(k):
        eng = k.engine(slots=1, cache_len=32, max_queue=2)
        for i, p in enumerate(_prompts(k.cfg, (4, 4))):
            eng.submit(k.request(i, p, max_new=2))
        with pytest.raises(ValueError, match="queue full") as ei:
            eng.submit(k.request(2, _prompts(k.cfg, (4,))[0], max_new=2))
        assert ei.value.reason == "queue_full"
        assert isinstance(ei.value, k.mod.Rejected)
        return eng
    ref, port = _both(kits, run)
    assert port.stats["rejected"] == 1


def test_queue_stays_bounded_under_sustained_over_admission(kits):
    def run(k):
        eng = k.engine(slots=1, cache_len=32, max_queue=3)
        prompt = _prompts(k.cfg, (4,))[0]
        rejected = 0
        for i in range(50):
            try:
                eng.submit(k.request(i, prompt, max_new=2))
            except k.mod.Rejected as e:
                assert e.reason == "queue_full"
                rejected += 1
            assert len(eng.queue) <= 3
        assert rejected == 50 - 3 == eng.stats["rejected"]
        assert len(eng.run()) == 3
        return eng
    _both(kits, run)


def test_poisoned_prompt_rejected(kits):
    def run(k):
        eng = k.engine(slots=1, cache_len=32)
        bad = k.flt.poison_prompt(_prompts(k.cfg, (6,))[0],
                                  k.cfg.vocab_size, seed=3)
        with pytest.raises(k.mod.Rejected, match="outside vocab") as ei:
            eng.submit(k.request(0, bad, max_new=2))
        assert ei.value.reason == "bad_prompt"
        with pytest.raises(k.mod.Rejected):
            eng.submit(k.request(1, np.zeros(0, np.int32), max_new=2))
        return eng, bad
    (ref, jbad), (port, bad) = run(kits["ref"]), run(kits["port"])
    np.testing.assert_array_equal(bad, jbad)
    _same(kits, ref, port)


def test_overflow_rejections_are_typed(kits):
    def run(k):
        eng = k.engine(slots=1, cache_len=16)
        for req, reason in ((k.request(0, np.zeros(17, np.int32), 1),
                             "prompt_overflow"),
                            (k.request(1, np.zeros(12, np.int32), 8),
                             "decode_overflow")):
            with pytest.raises(k.mod.Rejected) as ei:
                eng.submit(req)
            assert ei.value.reason == reason
        return eng
    _both(kits, run)


# ------------------------------------------------------------- deadlines

def test_deadline_expires_queued_request(kits):
    def run(k):
        clk = k.flt.FaultClock()
        eng = k.engine(slots=1, cache_len=32, clock=clk, deadline_s=10.0)
        p0, p1 = _prompts(k.cfg, (4, 4))
        eng.submit(k.request(0, p0, max_new=2))
        eng.submit(k.request(1, p1, max_new=2))
        clk.advance(11.0)
        eng.run()
        assert all(r.error == "deadline_exceeded" for r in eng.failed)
        assert eng.stats["expired"] == len(eng.failed) > 0
        return eng
    _both(kits, run)


def test_deadline_expires_in_flight_request(kits):
    def run(k):
        clk = k.flt.FaultClock()
        eng = k.engine(slots=1, cache_len=64, clock=clk)
        (p,) = _prompts(k.cfg, (4,))
        eng.submit(k.request(0, p, max_new=30, deadline=5.0))
        eng.step()
        assert eng.req[0] is not None
        clk.advance(6.0)
        eng.step()
        assert eng.req[0] is None
        (failed,) = eng.failed
        assert failed.error == "deadline_exceeded"
        assert eng.stats["expired"] == 1
        return eng
    _both(kits, run)


def test_submit_past_deadline_rejected(kits):
    def run(k):
        eng = k.engine(slots=1, cache_len=32,
                       clock=k.flt.FaultClock(start=100.0))
        with pytest.raises(k.mod.Rejected) as ei:
            eng.submit(k.request(0, _prompts(k.cfg, (4,))[0], max_new=2,
                                 deadline=99.0))
        assert ei.value.reason == "deadline"
        return eng
    _both(kits, run)


# ---------------------------------------------------------- tick watchdog

def test_nan_tick_retires_slot_with_structured_error(kits):
    def run(k):
        eng = k.engine(slots=2, cache_len=48, fused=True, watchdog_limit=100)
        inj = k.flt.TickFaultInjector("nan", every_n=1, limit=1).install(eng)
        for i, p in enumerate(_prompts(k.cfg, (5, 7))):
            eng.submit(k.request(i, p, max_new=MAX_NEW))
        eng.run()
        assert inj.injected == 1
        assert eng.stats["watchdog_trips"] == 1
        assert len(eng.failed) == 2
        for r in eng.failed:
            assert r.error == "non_finite_output" and len(r.out) == 1
        return eng
    _both(kits, run)


def test_repeated_nan_ticks_degrade_fused_to_serial(kits):
    def run(k):
        eng = k.engine(slots=1, cache_len=64, fused=True, watchdog_limit=2)
        k.flt.TickFaultInjector("nan", every_n=1, limit=2).install(eng)
        rng = np.random.default_rng(0)
        for i in range(4):
            eng.submit(k.request(i, rng.integers(0, k.cfg.vocab_size, 4)
                                 .astype(np.int32), max_new=3))
        eng.run()
        assert eng.stats["watchdog_trips"] == 2
        assert eng.stats["degradations"] == 1
        assert eng.fused is False
        assert any(f["action"] == "fused->serial" for f in eng.faults)
        assert len(eng.finished) == 2
        assert all(len(r.out) == 3 for r in eng.finished)
        return eng
    _both(kits, run)


def test_degraded_interp_engine_uses_guarded_numerics(kits):
    def run(k):
        eng = k.engine("interp", slots=1, cache_len=48, fused=True,
                       watchdog_limit=1)
        k.flt.TickFaultInjector("nan", every_n=1, limit=1).install(eng)
        rng = np.random.default_rng(1)
        for i in range(2):
            eng.submit(k.request(i, rng.integers(0, k.cfg.vocab_size, 4)
                                 .astype(np.int32), max_new=3))
        eng.run()
        assert eng.cfg.numerics == "interp-guarded"
        assert eng.numerics.__class__.__name__ == "GuardedNumerics"
        assert len(eng.finished) == 1
        return eng
    ref, port = _both(kits, run, numerics="interp")
    # the serial rung's guard clamps without reading back (no host sync)
    assert isinstance(port.numerics, GuardedNumerics)
    assert not port.numerics.count and port.numerics.violations == {}
    assert port.numerics.library is port.library


def test_dropped_tick_makes_no_silent_progress(kits):
    def run(k):
        eng = k.engine(slots=1, cache_len=48, fused=True, watchdog_limit=100)
        inj = k.flt.TickFaultInjector("drop", every_n=1, limit=1
                                      ).install(eng)
        (p,) = _prompts(k.cfg, (5,))
        eng.submit(k.request(0, p, max_new=MAX_NEW))
        eng.run()
        assert inj.injected == 1
        (failed,) = eng.failed
        assert failed.error == "non_finite_output" and len(failed.out) == 1
        return eng
    _both(kits, run)


def test_stalled_tick_trips_watchdog(kits):
    def run(k):
        clk = k.flt.FaultClock()
        eng = k.engine(slots=1, cache_len=48, fused=True, clock=clk,
                       max_tick_s=0.5, watchdog_limit=100)
        k.flt.TickFaultInjector("delay", every_n=1, delay_s=2.0,
                                limit=1).install(eng)
        (p,) = _prompts(k.cfg, (5,))
        eng.submit(k.request(0, p, max_new=MAX_NEW))
        eng.run()
        assert eng.stats["watchdog_trips"] == 1
        assert any(f["reason"] == "stalled_tick" for f in eng.faults)
        (done,) = eng.finished
        assert len(done.out) == MAX_NEW
        return eng
    _both(kits, run)


@pytest.mark.parametrize("mode,every_n,offset,limit",
                         [("nan", 2, 1, None), ("drop", 3, 0, 2),
                          ("nan", 1, 0, 3)])
def test_injector_schedules_walk_the_same_ladder(mode, every_n, offset,
                                                 limit, kits):
    """Longer seeded schedules on an interp engine with three slots: the
    same trips, rungs and retirements, tick for tick."""
    def run(k):
        eng = k.engine("interp", slots=3, cache_len=48, fused=True,
                       watchdog_limit=2, horizon=4)
        k.flt.TickFaultInjector(mode, every_n=every_n, offset=offset,
                                limit=limit).install(eng)
        for i, p in enumerate(_prompts(k.cfg, (5, 9, 3, 7, 4, 6), seed=3)):
            eng.submit(k.request(i, p, max_new=7))
        eng.run()
        return eng
    ref, port = _both(kits, run, numerics="interp")
    assert port.stats["watchdog_trips"] > 0


# ------------------------------------------------------------ ROM integrity

def test_flipped_rom_bit_detected_by_verify_resident(kits):
    lib, jlib = kits["port"].lib, kits["ref"].lib
    lib.verify_resident()
    for seed in (11, 12):
        flipped = faults.flip_rom_bit(lib, seed=seed)
        jflipped = jfaults.flip_rom_bit(jlib, seed=seed)
        assert flipped.rom_sha() == jflipped.rom_sha() != lib.rom_sha()
        assert flipped.device == lib.device
        with pytest.raises(LibraryIntegrityError, match="checksum") as e:
            flipped.verify_resident()
        with pytest.raises(JaxIntegrityError) as je:
            jflipped.verify_resident()
        assert str(e.value) == str(je.value)
    bit = faults.flip_rom_bit(lib, bit=70)
    assert (bit.coeffs != lib.coeffs).sum() == 1
    assert int((bit.coeffs ^ lib.coeffs).reshape(-1)[2]) == 1 << 6


def test_corrupt_rom_degrades_to_exact_with_identical_tokens(kits):
    def run(k):
        flipped = k.flt.flip_rom_bit(k.lib, seed=5)
        eng = k.engine("interp", library=flipped, slots=2, cache_len=48,
                       fused=True)
        assert eng.stats["rom_faults"] == 1
        assert eng.cfg.numerics == "exact" and eng.library is None
        assert any(f["reason"] == "rom_integrity" for f in eng.faults)
        ref = k.engine(slots=2, cache_len=48, fused=True)
        for e in (eng, ref):
            for i, p in enumerate(_prompts(k.cfg, (5, 11, 3))):
                e.submit(k.request(i, p, max_new=MAX_NEW))
        assert _streams_run(eng) == _streams_run(ref)
        return eng
    _both(kits, run)


def _streams_run(eng) -> dict:
    return {r.rid: list(r.out) for r in eng.run()}


def test_periodic_rom_verify_catches_runtime_corruption(kits):
    def run(k):
        eng = k.engine("interp", slots=1, cache_len=64, fused=True,
                       verify_rom_every=1)
        rng = np.random.default_rng(2)
        eng.submit(k.request(0, rng.integers(0, k.cfg.vocab_size, 4)
                             .astype(np.int32), max_new=12))
        eng.step(2)
        eng.library = k.flt.flip_rom_bit(eng.library, seed=9)
        eng.step(2)
        assert eng.stats["rom_faults"] == 1
        assert eng.cfg.numerics == "exact" and eng.library is None
        eng.run()
        (done,) = eng.finished
        assert len(done.out) == 12
        return eng
    _both(kits, run, numerics="interp")


def test_assigned_library_rebinds_the_numerics(kits):
    """Assigning ``engine.library`` rebinds the numerics (the reference's
    tick reads the library it is handed): ticks after the swap read the
    new ROM, as an engine built on it does from then on."""
    k = kits["port"]
    other = k.lib.__class__(k.lib.coeffs.clone(), k.lib.metas).seal()
    eng = k.engine("interp", slots=1, cache_len=64, fused=True)
    assert eng.numerics.library is k.lib
    eng.library = other
    assert eng.numerics.library is other and eng.numerics.fused
    eng.submit(k.request(0, _prompts(k.cfg, (4,))[0], max_new=6))
    want = k.engine("interp", library=other, slots=1, cache_len=64)
    want.submit(k.request(0, _prompts(k.cfg, (4,))[0], max_new=6))
    assert _streams_run(eng) == _streams_run(want)


# ------------------------------------------------------------ the fused tick

def _serve(k, *, fused, slots=2, cache_len=48, horizon=8, numerics=None,
           lengths=(5, 11, 3), max_new=6):
    eng = k.engine(numerics, slots=slots, cache_len=cache_len, fused=fused,
                   horizon=horizon)
    for i, p in enumerate(_prompts(k.cfg, lengths)):
        eng.submit(k.request(i, p, max_new=max_new))
    return eng, _streams_run(eng)


def test_fused_tokens_bitwise_equal_serial_exact_numerics(kits):
    """Exact numerics: the fused tick and the serial path decode the same
    tokens, in the port and against the reference."""
    outs = {}
    for name, k in kits.items():
        for fused in (False, True):
            _, outs[name, fused] = _serve(k, fused=fused)
    assert outs["port", True] == outs["port", False]
    assert outs["port", True] == outs["ref", True] == outs["ref", False]


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_fused_mixed_length_batching_matches_solo_oracle(arch):
    """The reference's oracle through the port's fused engine with interp
    numerics: batching is invisible, each request decodes as if served
    alone (in a one-slot engine, as the reference's test)."""
    k = _kits(arch)["port"]
    prompts = _prompts(k.cfg, (5, 11, 3))
    _, done = _serve(k, fused=True, numerics="interp", max_new=6)
    for i, p in enumerate(prompts):
        solo = k.engine("interp", slots=1, cache_len=48, fused=True)
        solo.submit(k.request(i, p, max_new=6))
        (ref,) = solo.run()
        assert done[i] == ref.out, f"request {i} (len {len(p)}) diverged"


def test_fused_horizon_chunking_is_invisible(kits):
    k = kits["port"]
    outs = [_serve(k, fused=True, numerics="interp", horizon=h,
                   lengths=(4, 9))[1] for h in (1, 3, 8)]
    assert outs[0] == outs[1] == outs[2]


def test_fused_tick_updates_buffers_in_place(kits):
    """The twin of the reference's donation test: across ticks the KV pool
    and the slot-state buffers keep their storage (a CUDA graph bakes their
    addresses in)."""
    k = kits["port"]
    eng = k.engine(slots=2, cache_len=64, fused=True)
    eng.submit(k.request(0, _prompts(k.cfg, (5,))[0], max_new=24))
    ptrs = [t.data_ptr() for t in (*eng.caches, eng._tok, eng._pos,
                                   eng._live, eng._ok, eng._block)]
    cache = eng.caches
    for _ in range(3):
        eng.step(4)
        assert eng.caches is cache
        assert [t.data_ptr() for t in (*eng.caches, eng._tok, eng._pos,
                                       eng._live, eng._ok,
                                       eng._block)] == ptrs
    assert eng.stats["decode_steps"] == 12


def test_fused_dispatch_counts_collapse(kits):
    """One dispatch and one transfer per tick on the fused path, two
    dispatches per token on the serial one, counted as the reference
    counts them."""
    stats = {}
    for name, k in kits.items():
        for fused in (False, True):
            eng, _ = _serve(k, fused=fused, lengths=(5, 9), max_new=9)
            stats[name, fused] = dict(eng.stats)
    for key in ("dispatches", "transfers", "ticks", "decode_steps",
                "admit_dispatches"):
        for fused in (False, True):
            assert stats["port", fused][key] == stats["ref", fused][key]
    serial, fused_s = stats["port", False], stats["port", True]
    assert serial["dispatches"] == 2 * serial["decode_steps"]
    assert fused_s["dispatches"] == fused_s["ticks"] == fused_s["transfers"]
    assert fused_s["decode_steps"] > 2 * fused_s["ticks"]
    assert fused_s["dispatches"] < serial["dispatches"] / 4


def test_interp_fused_backend_name_serves(kits):
    k = kits["port"]
    _, a = _serve(k, fused=True, numerics="interp-fused", lengths=(5,),
                  max_new=4)
    _, b = _serve(k, fused=True, numerics="interp", lengths=(5,), max_new=4)
    assert a == b and len(a[0]) == 4


def test_serial_interp_path_matches_reference(kits):
    """The serial oracle with interp numerics: the unfused backend bound to
    the library, one decode and a host argmax per token, as the
    reference's serial path."""
    def run(k):
        eng, _ = _serve(k, fused=False, numerics="interp")
        assert type(eng.numerics).__name__ == "InterpNumerics"
        return eng
    _both(kits, run, numerics="interp")


def test_graph_is_off_on_the_cpu_and_named_in_stats(kits):
    k = kits["port"]
    eng = k.engine(slots=1, cache_len=32)
    assert eng.stats["graph"] is False
    assert eng.stats["graph_reason"] == "eager: no CUDA device"
    assert eng.stats["captures"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        k.engine(slots=1, cache_len=32, graph=True)
    assert engine.chunk_sizes(8) == (1, 2, 4, 8)
    assert engine.chunk_sizes(3) == (1, 2)
    assert engine.chunk_sizes(1) == (1,)
