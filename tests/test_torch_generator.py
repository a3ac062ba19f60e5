"""The design-space generator of the port (``repro_torch.api.Explorer`` down
to ``core``), held against the reference on the CPU: the vendored default
tables regenerate byte-identical, ``compile()`` gives the reference's ROM
checksum under every engine, designs equal the reference's, and the
reference's own invariants hold inside the port (the engines agree,
``min_regions`` equals the linear scan, the fleet equals the serial path,
``fleet_alg1`` equals Algorithm 1).

The device paths (``engine="pallas"``, ``mesh=2``) run with
``device="cpu"``, i.e. through the kernels' plain versions.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.api as japi
from repro_torch.api import (DEFAULT_LIBRARY_KINDS, DEFAULTS, Explorer,
                             ExploreConfig, InterpLibrary, get_spec)
from repro_torch.api.library import DEFAULT_TABLE_KEY, TABLES_DIR
from repro_torch.core import batched, fleet
from repro_torch.core.decision import (IntervalSet, alg1_interval_precision,
                                      run_decision)
from repro_torch.kernels.dspace import ops as dops

ROM_SHA = "12aa483ae8456c2f"  # the vendored default library


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    """The default manifest compiled from nothing by the exact engine."""
    d = tmp_path_factory.mktemp("tables")
    lib = Explorer(ExploreConfig(cache_dir=str(d), device="cpu")).compile()
    return d, lib


@pytest.mark.parametrize("kind", DEFAULT_LIBRARY_KINDS)
def test_vendored_table_regenerates_byte_identical(kind, regenerated):
    d, _ = regenerated
    name = f"{kind}_{DEFAULT_TABLE_KEY}.json"
    assert (d / name).read_bytes() == (TABLES_DIR / name).read_bytes()


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(dops, name)

    def counted(*a):
        calls.append(a[0].shape)
        return fn(*a)

    monkeypatch.setattr(dops, name, counted)
    return calls


@pytest.mark.parametrize("config,device_kernel", [
    ({}, None),
    ({"engine": "pallas"}, "envelopes_parity_batched"),
    ({"mesh": 2}, "envelopes_parity_fleet")])
def test_compile_rom_sha(config, device_kernel, tmp_path, monkeypatch,
                         regenerated):
    """``compile()`` under the exact engine, the pallas engine and the
    fleet device path gives the vendored library's checksum; the device
    paths really run their envelope kernel's (plain) version."""
    calls = (_count_calls(monkeypatch, device_kernel) if device_kernel
             else [])
    lib = Explorer(ExploreConfig(cache_dir=str(tmp_path), device="cpu",
                                 **config)).compile()
    assert lib.rom_sha() == ROM_SHA
    assert InterpLibrary.default_library("cpu").rom_sha() == ROM_SHA
    assert lib.metas == regenerated[1].metas
    assert bool(calls) == bool(device_kernel)


def test_compile_matches_reference_library(tmp_path):
    """The reference's compile() of the same manifest: same metadata and
    ROM checksum."""
    with japi.Explorer(japi.ExploreConfig(
            cache_dir=str(tmp_path / "ref"))) as ex:
        jlib = ex.compile()
    lib = Explorer(ExploreConfig(cache_dir=str(tmp_path / "port"),
                                 device="cpu")).compile()
    assert lib.rom_sha() == jlib.rom_sha()
    assert [m.to_dict() for m in lib.metas] == [
        {k: v for k, v in m.to_dict().items()
         if k not in ("seg_depth", "seg_meta")} for m in jlib.metas]


def test_compile_act_windows_match_reference(tmp_path):
    """A non-default activation window reaches the library metadata (and
    so the float glue), as in the reference."""
    kinds = [("silu", {"lo": -4.0, "hi": 4.0})]
    with japi.Explorer(japi.ExploreConfig(
            cache_dir=str(tmp_path / "ref"))) as ex:
        jm = ex.compile(kinds).meta("silu")
        jsha = ex.compile(kinds).rom_sha()
    lib = Explorer(ExploreConfig(cache_dir=str(tmp_path / "port"),
                                 device="cpu")).compile(kinds)
    m = lib.meta("silu")
    assert (m.act_lo, m.act_hi, m.act_span) == (jm.act_lo, jm.act_hi,
                                                jm.act_span) == (-4.0, 4.0,
                                                                 8.0)
    assert lib.rom_sha() == jsha


@pytest.mark.parametrize("kind,bits,kw", [("recip", 10, {}),
                                          ("log2", 10, {"out_bits": 11}),
                                          ("exp2", 10, {"out_bits": 10})])
@pytest.mark.parametrize("engine", ["batched", "pallas"])
def test_explore_matches_reference(kind, bits, kw, engine, tmp_path):
    """Table I's 10-bit rows: the full frontier (min R, every height's
    design) equals the reference's exact engine's, under the port's exact
    and device engines."""
    spec_kw = dict(kind=kind, bits=bits, **kw)
    want = japi.Explorer(japi.ExploreConfig(cache_dir=str(tmp_path))).explore(
        japi.get_spec(**{"kind": kind, "bits": bits, **kw}))
    got = Explorer(ExploreConfig(engine=engine, device="cpu",
                                 cache_dir=str(tmp_path))).explore(
        get_spec(**spec_kw))
    assert got.min_regions_r == want.min_regions_r
    assert [e.design.to_dict() for e in got.entries] == [
        e.design.to_dict() for e in want.entries]
    assert got.best.design.to_dict() == want.best.design.to_dict()


@pytest.mark.parametrize("engine", ["pooled", "batched", "pallas"])
def test_engines_produce_identical_designs(engine):
    """Mirror of the reference's engine equivalence, inside the port."""
    spec = get_spec("recip", 8)
    with Explorer(ExploreConfig(engine="batched", device="cpu")) as ex:
        ref = ex.explore_r(spec, 3)
    with Explorer(ExploreConfig(engine=engine, device="cpu",
                                workers=2)) as ex:
        got = ex.explore_r(spec, 3)
    assert ref is not None and got is not None
    assert got.design.to_dict() == ref.design.to_dict()


@pytest.mark.parametrize("kind,bits,lookup_bits", [("recip", 8, 3),
                                                   ("silu", 8, 3)])
def test_run_decision_engines_identical(kind, bits, lookup_bits):
    spec = get_spec(kind, bits)
    out = {e: run_decision(spec, lookup_bits, engine=e, device="cpu")
           for e in ("pooled", "batched", "pallas")}
    designs = {e: o[0].to_dict() for e, o in out.items()}
    assert designs["pooled"] == designs["batched"] == designs["pallas"]


def test_min_regions_binary_matches_linear_scan():
    with Explorer(ExploreConfig(device="cpu")) as ex:
        for kind in DEFAULTS:
            spec = ExploreConfig(kind=kind, bits=8).spec()
            fast = ex.min_regions(spec)
            linear = next((r for r in range(spec.in_bits + 1)
                           if ex.feasible(spec, r)), None)
            assert fast == linear, kind
            assert all(ex.feasible(spec, r)
                       for r in range(fast, spec.in_bits + 1)), kind


def test_min_regions_many_matches_serial():
    specs = [ExploreConfig(kind=k, bits=8).spec() for k in DEFAULTS]
    with Explorer(ExploreConfig(device="cpu")) as ex:
        many = ex.min_regions_many(specs)
    with Explorer(ExploreConfig(device="cpu", fleet=False)) as ex:
        serial = [ex.min_regions(s) for s in specs]
    assert many == serial


def test_fleet_compile_bit_identical_to_serial(tmp_path):
    with Explorer(ExploreConfig(cache_dir=str(tmp_path / "fleet"),
                                device="cpu")) as ex:
        lib_fleet = ex.compile()
    with Explorer(ExploreConfig(cache_dir=str(tmp_path / "serial"),
                                fleet=False, device="cpu")) as ex:
        lib_serial = ex.compile()
    assert lib_fleet.metas == lib_serial.metas
    assert torch.equal(lib_fleet.coeffs, lib_serial.coeffs)
    assert sorted(p.name for p in (tmp_path / "fleet").glob("*.json")) == \
        sorted(p.name for p in (tmp_path / "serial").glob("*.json"))


def test_fleet_region_spaces_equal_batched():
    """The stacked fleet program == the per-probe batched engine, bitwise,
    on a ragged stack of real specs."""
    pairs = [("recip", 8, 3), ("exp2", 8, 4), ("silu", 8, 2)]
    bounds = [get_spec(k, b).region_bounds(r) for k, b, r in pairs]
    got = fleet.fleet_region_spaces(bounds)
    for (L, U), spaces in zip(bounds, got):
        for g, w in zip(spaces, batched.region_spaces(L, U)):
            assert g.feasible == w.feasible
            np.testing.assert_array_equal(g.big_m, w.big_m)
            np.testing.assert_array_equal(g.small_m, w.small_m)
            np.testing.assert_array_equal([g.a_lo, g.a_hi], [w.a_lo, w.a_hi])


def _rand_interval_sets(rng, n_regions, max_iv, lo, hi):
    sets = []
    for _ in range(n_regions):
        ivs = []
        for _ in range(rng.integers(1, max_iv + 1)):
            a, b = sorted(rng.integers(lo, hi, 2).tolist())
            ivs.append((int(a), int(b)))
        sets.append(IntervalSet(tuple(ivs)))
    return sets


@pytest.mark.parametrize("lo,hi", [(-50, 50), (0, 1 << 20),
                                   (-(1 << 40), -3), (-5, 5), (1, 2)])
def test_fleet_alg1_bit_identical(lo, hi):
    """The vectorized Algorithm 1 picks the scalar routine's (bits, shift,
    signed) on random interval unions spanning signs, zeros and wide
    magnitudes."""
    rng = np.random.default_rng(abs(lo) + abs(hi))
    for _ in range(40):
        sets = _rand_interval_sets(rng, int(rng.integers(1, 9)), 3, lo, hi)
        assert fleet.fleet_alg1(sets) == alg1_interval_precision(sets), sets


def test_exact_engine_never_touches_the_device(tmp_path):
    """``device`` defaults to "cuda", but only the device paths read it:
    the exact engine explores and compiles its tables without a card."""
    ex = Explorer(ExploreConfig(cache_dir=str(tmp_path)))
    assert ex.explore(get_spec("recip", 8)).best is not None
    assert ex.get_table("recip").fits_int32
