"""The port's Explorer / Target API against the reference's (twins of
``tests/api/test_explorer.py``): the legacy shims, the target registry,
envelope reuse and its LRU, the region engines, the min-R searches, the
fleet engine and the result object.

Each twin runs the reference's scenario in both packages and asserts the
port's designs (``TableDesign.to_dict()``), verdicts, minimum heights,
cache counters and error messages equal the reference's, then runs the
reference's own assertions on the port. Sessions get fresh cache
directories (both packages' default Explorers too), so every table is
generated. The device paths (``engine="pallas"``, ``mesh=2``) run with
``device="cpu"``, through the envelope kernels' plain versions; their card
counterparts are in ``tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.config import DEFAULTS as JAX_DEFAULTS
from repro.api.target import _REGISTRY as JAX_REGISTRY
from repro.core.area import AreaDelay as JaxAreaDelay
from repro.core.generate import generate_table as jax_generate_table
from repro_torch import api
from repro_torch.api import (DecisionPolicy, ExploreConfig, Explorer,
                             get_spec, get_target, list_targets,
                             register_target)
from repro_torch.api.config import DEFAULTS
from repro_torch.api.target import _REGISTRY
from repro_torch.core.area import AreaDelay
from repro_torch.core.generate import generate_table

ROM_SHA = "12aa483ae8456c2f"  # the default manifest's ROM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fresh_default_sessions(tmp_path_factory):
    """Both packages' default Explorers (what the legacy shims use) on
    fresh cache directories, restored after."""
    old, jold = api.default_explorer(), japi.default_explorer()
    api.set_default_explorer(Explorer(ExploreConfig(
        device="cpu", cache_dir=str(tmp_path_factory.mktemp("port")))))
    japi.set_default_explorer(japi.Explorer(japi.ExploreConfig(
        cache_dir=str(tmp_path_factory.mktemp("ref")))))
    yield
    api.set_default_explorer(old)
    japi.set_default_explorer(jold)


@pytest.fixture
def sessions(tmp_path):
    """``make(**config)`` -> (port Explorer on the CPU, reference Explorer),
    each on its own fresh cache directory; closed after the test."""
    made = []

    def make(**kw):
        n = len(made)
        ex = Explorer(ExploreConfig(device="cpu",
                                    cache_dir=str(tmp_path / f"p{n}"), **kw))
        jex = japi.Explorer(japi.ExploreConfig(
            cache_dir=str(tmp_path / f"r{n}"), **kw))
        made.extend((ex, jex))
        return ex, jex

    yield make
    for ex in made:
        ex.close()


def _d(entry_or_design):
    design = getattr(entry_or_design, "design", entry_or_design)
    return None if design is None else design.to_dict()


def _specs(kind, bits, **kw):
    return get_spec(kind, bits, **kw), japi.get_spec(kind, bits, **kw)


# ------------------------------------------------------------- back-compat

@pytest.mark.parametrize("kind,bits", [("recip", 8), ("exp2", 8)])
def test_generate_table_shim_matches_explorer_best(kind, bits, sessions):
    spec, jspec = _specs(kind, bits)
    legacy, jlegacy = generate_table(spec), jax_generate_table(jspec)
    ex, _ = sessions()
    best = ex.explore(spec, target="asic").best
    assert _d(legacy) == _d(best) == _d(jlegacy)
    assert (legacy.area, legacy.delay) == (best.area, best.delay) == (
        jlegacy.area, jlegacy.delay)


def test_explore_fixed_r_matches_legacy_error():
    spec, jspec = _specs("recip", 8)
    with pytest.raises(ValueError, match="no feasible design") as got:
        generate_table(spec, lookup_bits=0)
    with pytest.raises(ValueError, match="no feasible design") as want:
        jax_generate_table(jspec, lookup_bits=0)
    assert str(got.value) == str(want.value)


def test_config_spec_with_explicit_bits_matches_get_spec():
    for kind, bits in (("log2", 16), ("log2", None), ("recip", 10)):
        kw = {} if bits is None else {"bits": bits}
        got = ExploreConfig(kind=kind, **kw).spec()
        want = japi.ExploreConfig(kind=kind, **kw).spec()
        assert (got.in_bits, got.out_bits, got.name) == (
            want.in_bits, want.out_bits, want.name)
    assert ExploreConfig(kind="log2", bits=16).spec().out_bits == \
        get_spec("log2", 16).out_bits == 17
    assert ExploreConfig(kind="log2").spec().out_bits == 13


def test_config_degree_consistent_across_entry_points(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions(degree=1)
    assert ex.explore_r(spec, 2) is None and jex.explore_r(jspec, 2) is None
    assert not ex.explore(spec, lookup_bits=2).entries
    assert not jex.explore(jspec, lookup_bits=2).entries
    e4 = ex.explore_r(spec, 4)
    assert e4.design.degree == 1
    assert _d(e4) == _d(jex.explore_r(jspec, 4))


def _tiny_k(register, area_delay, name):
    @register(name)
    class TinyK:
        policy = None

        def estimate(self, design):
            return area_delay(1.0, 1.0)

        def objective(self, design, ad):
            return 0.0

    return TinyK


def test_target_policy_k_max_respected(tmp_path):
    """``ExploreConfig.k_max=None`` defers to the target policy's cap; an
    explicit cap overrides it; both packages agree."""
    tgt = _tiny_k(register_target, AreaDelay, "test-kmax")
    jtgt = _tiny_k(japi.register_target, JaxAreaDelay, "test-kmax")
    tgt.policy = DecisionPolicy(k_max=3)
    jtgt.policy = japi.DecisionPolicy(k_max=3)
    spec, jspec = _specs("recip", 8)
    try:
        for i, k_max in enumerate((None, 24)):
            with Explorer(ExploreConfig(k_max=k_max, device="cpu",
                                        cache_dir=str(tmp_path / f"p{i}"))
                          ) as ex, japi.Explorer(japi.ExploreConfig(
                              k_max=k_max, cache_dir=str(tmp_path / f"r{i}"))
                          ) as jex:
                got = ex.explore_r(spec, 2, target="test-kmax")
                want = jex.explore_r(jspec, 2, target="test-kmax")
                assert (got is None) == (k_max is None) == (want is None)
                assert _d(got) == _d(want)
    finally:
        _REGISTRY.pop("test-kmax", None)
        JAX_REGISTRY.pop("test-kmax", None)


# --------------------------------------------------------- target registry

def test_builtin_targets_registered():
    assert {"asic", "fpga-lut", "pallas-tpu"} <= set(list_targets())
    assert set(list_targets()) == set(japi.list_targets())


def test_register_target_roundtrip():
    @register_target("test-rt")
    class TestTarget:
        policy = DecisionPolicy(maximize_sq_trunc=False)

        def estimate(self, design):
            return AreaDelay(1.0, 1.0)

        def objective(self, design, ad):
            return design.lookup_bits

    try:
        tgt = get_target("test-rt")
        assert tgt.name == "test-rt"
        assert not tgt.policy.maximize_sq_trunc
        assert "test-rt" in list_targets()
        assert "test-rt" not in japi.list_targets()
        assert get_target(tgt) is tgt
        assert TestTarget is tgt
        assert callable(get_target(tgt).estimate)
    finally:
        _REGISTRY.pop("test-rt", None)
    assert "test-rt" not in list_targets()


def test_unknown_target_raises():
    with pytest.raises(KeyError, match="unknown target") as got:
        get_target("not-a-technology")
    with pytest.raises(KeyError, match="unknown target") as want:
        japi.get_target("not-a-technology")
    assert str(got.value) == str(want.value)


# ---------------------------------------------- all targets produce valid HW

def test_all_builtin_targets_best_designs_verify(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions()
    for name in ("asic", "fpga-lut", "pallas-tpu"):
        res, jres = ex.explore(spec, target=name), jex.explore(jspec,
                                                              target=name)
        assert res, f"target {name}: no feasible design"
        assert _d(res.best) == _d(jres.best), name
        assert (res.best.area, res.best.delay) == (jres.best.area,
                                                   jres.best.delay), name
        ok, worst = res.best.design.verify(spec)
        assert ok, f"target {name}: best design invalid (worst={worst})"
        assert res.target == jres.target == name


def test_pallas_policy_skips_truncation_steps(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions()
    e = ex.explore_r(spec, 2, target="pallas-tpu", degree=2)
    assert e is not None
    assert _d(e) == _d(jex.explore_r(jspec, 2, target="pallas-tpu",
                                     degree=2))
    assert e.report.sq_trunc == 0 and e.report.lin_trunc == 0


# ------------------------------------------------------------ envelope reuse

def test_envelopes_computed_once_per_spec_r(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions()
    for e, s in ((ex, spec), (jex, jspec)):
        e.explore(s, target="asic")
    computed = ex.envelope_stats["computed"]
    assert computed == jex.envelope_stats["computed"]
    base = dict(ex._spaces)
    for name in ("fpga-lut", "pallas-tpu", "asic"):
        ex.explore(spec, target=name)
        jex.explore(jspec, target=name)
    assert ex.envelope_stats == jex.envelope_stats
    assert ex.envelope_stats["computed"] == computed, \
        "retargeting recomputed envelopes"
    assert ex.envelope_stats["hits"] > 0
    for key, spaces in base.items():
        assert ex._spaces[key] is spaces


def test_envelope_reuse_returns_identical_bounds(sessions):
    spec, jspec = _specs("exp2", 8)
    ex, jex = sessions()
    first, second = ex.envelopes(spec, 3), ex.envelopes(spec, 3)
    jex.envelopes(jspec, 3)
    jfirst = jex.envelopes(jspec, 3)
    assert first is second
    for a, b in zip(first, jfirst):
        np.testing.assert_array_equal(a.big_m, b.big_m)
        np.testing.assert_array_equal(a.small_m, b.small_m)
        assert a.feasible == b.feasible
    assert ex.envelope_stats == jex.envelope_stats == {
        "computed": 1, "hits": 1, "evictions": 0}


def test_envelope_cache_lru_bound(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions(envelope_cache=2)
    stats = []
    for e, s in ((ex, spec), (jex, jspec)):
        seen = []
        for r in (2, 3, 3, 4):  # R=3 most recent, then R=4 evicts R=2
            e.envelopes(s, r)
        seen.append((dict(e.envelope_stats), len(e._spaces)))
        e.envelopes(s, 3)  # still cached
        seen.append(dict(e.envelope_stats))
        e.envelopes(s, 2)  # evicted -> recomputed
        seen.append(dict(e.envelope_stats))
        stats.append(seen)
    assert stats[0] == stats[1]
    assert stats[0][0] == ({"computed": 3, "hits": 1, "evictions": 1}, 2)
    assert stats[0][1]["hits"] == 2
    assert stats[0][2]["computed"] == 4 and stats[0][2]["evictions"] == 2


def test_unbounded_envelope_cache(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions(envelope_cache=None)
    for r in range(6):
        ex.envelopes(spec, r)
        jex.envelopes(jspec, r)
    assert ex.envelope_stats == jex.envelope_stats
    assert ex.envelope_stats["evictions"] == 0
    assert len(ex._spaces) == len(jex._spaces) == 6


# ------------------------------------------------------------ region engine

def test_engine_knob_validated():
    with pytest.raises(ValueError, match="unknown engine") as got:
        Explorer(ExploreConfig(engine="nope", device="cpu"))
    with pytest.raises(ValueError, match="unknown engine") as want:
        japi.Explorer(japi.ExploreConfig(engine="nope"))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("engine", ["pooled", "batched", "pallas"])
def test_engines_produce_identical_designs(engine, sessions):
    """Every engine of the port (``pallas`` through the plain versions)
    yields the reference's batched design."""
    spec, jspec = _specs("recip", 8)
    ex, _ = sessions(engine=engine)
    _, jex = sessions(engine="batched")
    got, want = ex.explore_r(spec, 3), jex.explore_r(jspec, 3)
    assert got is not None and want is not None
    assert _d(got) == _d(want)


def test_min_regions_binary_matches_linear_scan(sessions):
    assert list(DEFAULTS) == list(JAX_DEFAULTS)
    ex, jex = sessions()
    for kind in DEFAULTS:
        spec = ExploreConfig(kind=kind, bits=8).spec()
        fast = ex.min_regions(spec)
        assert fast == jex.min_regions(japi.ExploreConfig(kind=kind,
                                                          bits=8).spec())
        linear = next((r for r in range(spec.in_bits + 1)
                       if ex.feasible(spec, r)), None)
        assert fast == linear, kind
        assert all(ex.feasible(spec, r)
                   for r in range(fast, spec.in_bits + 1)), kind


def test_min_regions_r_max_cutoff(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions()
    true_min = ex.min_regions(spec)
    assert true_min == jex.min_regions(jspec) == 2
    for r_max in (true_min - 1, true_min):
        assert ex.min_regions(spec, r_max=r_max) == jex.min_regions(
            jspec, r_max=r_max)
    assert ex.min_regions(spec, r_max=true_min - 1) is None
    assert ex.min_regions(spec, r_max=true_min) == true_min


# ------------------------------------------------------------ fleet engine

@pytest.fixture(scope="module")
def jax_manifest(tmp_path_factory):
    """The reference's default manifest compiled from nothing: its library
    and the table files it wrote."""
    d = tmp_path_factory.mktemp("ref_manifest")
    with japi.Explorer(japi.ExploreConfig(cache_dir=str(d))) as jex:
        jlib = jex.compile()
    return jlib, {p.name: p.read_bytes() for p in d.glob("*.json")}


def test_fleet_compile_bit_identical_to_serial(tmp_path, jax_manifest):
    """The manifest through the fleet engine equals the serial per-kind
    path and the reference's compile: metadata, ROM and table files."""
    jlib, jfiles = jax_manifest
    libs = {}
    for name, fleet in (("fleet", True), ("serial", False)):
        with Explorer(ExploreConfig(cache_dir=str(tmp_path / name),
                                    fleet=fleet, device="cpu")) as ex:
            libs[name] = ex.compile()
    lib_fleet, lib_serial = libs["fleet"], libs["serial"]
    assert lib_fleet.kinds == lib_serial.kinds == tuple(jlib.kinds)
    assert lib_fleet.metas == lib_serial.metas
    assert [m.to_dict() for m in lib_fleet.metas] == [
        m.to_dict() for m in jlib.metas]
    assert torch.equal(lib_fleet.coeffs, lib_serial.coeffs)
    np.testing.assert_array_equal(lib_fleet.coeffs.numpy(),
                                  np.asarray(jlib.coeffs))
    assert lib_fleet.rom_sha() == jlib.rom_sha() == ROM_SHA
    for name in ("fleet", "serial"):
        files = {p.name: p.read_bytes()
                 for p in (tmp_path / name).glob("*.json")}
        assert files == jfiles and files


def test_fleet_compile_warm_cache_short_circuits(tmp_path):
    """A second fleet compile loads every table from the cache: no new
    disk writes, the same ROM."""
    with Explorer(ExploreConfig(cache_dir=str(tmp_path),
                                device="cpu")) as ex:
        lib1 = ex.compile(["recip", "exp2neg"])
        stamp = {p.name: p.stat().st_mtime_ns for p in tmp_path.glob("*.json")}
        lib2 = ex.compile(["recip", "exp2neg"])
        assert {p.name: p.stat().st_mtime_ns
                for p in tmp_path.glob("*.json")} == stamp
    assert torch.equal(lib1.coeffs, lib2.coeffs)
    with japi.Explorer(japi.ExploreConfig(
            cache_dir=str(tmp_path / "ref"))) as jex:
        jlib = jex.compile(["recip", "exp2neg"])
    np.testing.assert_array_equal(lib1.coeffs.numpy(), np.asarray(jlib.coeffs))


def test_min_regions_many_matches_serial(sessions):
    specs = [ExploreConfig(kind=k, bits=8).spec() for k in DEFAULTS]
    jspecs = [japi.ExploreConfig(kind=k, bits=8).spec() for k in DEFAULTS]
    ex, jex = sessions()
    many = ex.min_regions_many(specs)
    assert many == jex.min_regions_many(jspecs)
    assert ex.feasible_stats["computed"] > 0
    assert ex.feasible_stats == jex.feasible_stats
    hits0 = ex.feasible_stats["hits"]
    assert ex.min_regions_many(specs) == many
    assert ex.feasible_stats["hits"] > hits0
    ex2, _ = sessions()
    assert many == [ex2.min_regions(s) for s in specs]


def test_explore_sweep_primes_envelopes_through_fleet(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions()
    res = ex.explore(spec, r_lo=2, r_hi=5)
    jres = jex.explore(jspec, r_lo=2, r_hi=5)
    assert [e.lookup_bits for e in res] == [2, 3, 4, 5]
    assert [_d(e) for e in res] == [_d(e) for e in jres]
    assert ex.envelope_stats == jex.envelope_stats
    assert ex.envelope_stats["computed"] == 4
    assert ex.envelope_stats["hits"] >= 4


def test_mesh_device_spaces_never_poison_exact_cache(sessions):
    """Under ``mesh > 1`` the fleet's front half runs in float32 (here its
    plain versions on the CPU); those spaces never enter the exact
    engine's cache, and the verdicts are the reference's."""
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions(mesh=2)
    spaces = ex._envelopes_fleet([(spec, 3)])
    jspaces = jex._envelopes_fleet([(jspec, 3)])
    assert len(spaces[0]) == len(jspaces[0]) == 8
    assert [s.feasible for s in spaces[0]] == [s.feasible for s in jspaces[0]]
    assert ex.envelope_stats["computed"] == 0
    assert not ex._spaces
    assert ex.feasible(spec, 3) == ex.feasible(spec, 3) == jex.feasible(
        jspec, 3)


def test_feasible_cache_lru_stats(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions()
    for e, s in ((ex, spec), (jex, jspec)):
        e._FEAS_CACHE_CAP = 2
        for r in (3, 3, 4, 5):  # R=5 evicts R=3
            e.feasible(s, r)
    assert ex.feasible_stats == jex.feasible_stats
    assert ex.feasible_stats == {"computed": 3, "hits": 1, "evictions": 1}
    assert len(ex._feasible) == 2


# ------------------------------------------------------------ result object

def test_result_frontier_pareto_and_min_regions(sessions):
    spec, jspec = _specs("recip", 8)
    ex, jex = sessions()
    res, jres = ex.explore(spec), jex.explore(jspec)
    assert res.min_regions_r == jres.min_regions_r == 2
    assert res.minimal_regions.lookup_bits == 2
    assert [_d(e) for e in res] == [_d(e) for e in jres]
    heights = [e.lookup_bits for e in res]
    assert heights == sorted(heights)
    front = res.pareto()
    assert front, "empty Pareto front"
    assert [(e.area, e.delay) for e in front] == [
        (e.area, e.delay) for e in jres.pareto()]
    for i, e in enumerate(front):
        for f in front[i + 1:]:
            assert not (f.area <= e.area and f.delay <= e.delay)
    assert res.best in res.entries
    assert _d(res.best) == _d(jres.best)


def test_explorer_get_table_caches(tmp_path):
    cfg = ExploreConfig(cache_dir=str(tmp_path), device="cpu")
    with Explorer(cfg) as ex:
        t1 = ex.get_table("recip", bits=8, lookup_bits=4)
        path = tmp_path / "recip_8b_R4_d0.json"
        assert path.exists()
        assert ex.get_table("recip", bits=8, lookup_bits=4) is t1
    with Explorer(cfg) as ex2:
        assert ex2.get_table("recip", bits=8, lookup_bits=4).to_dict() == \
            t1.to_dict()
    with japi.Explorer(japi.ExploreConfig(
            cache_dir=str(tmp_path / "ref"))) as jex:
        jex.get_table("recip", bits=8, lookup_bits=4)
    assert path.read_bytes() == (tmp_path / "ref" / path.name).read_bytes()
