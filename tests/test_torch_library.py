"""The port's InterpLibrary against the reference's: vendored tables, ROM
checksum, and the shared npz + json artifact format in both directions;
ROM v2 (segmented slots beside uniform ones: the twins of
``tests/segment/test_library_v2.py``)."""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DEFAULT_LIBRARY_KINDS, default_explorer
from repro.api.config import spec_for as jax_spec_for
from repro.api.library import InterpLibrary as JaxLibrary
from repro.segment import explore_segmented as jax_explore_segmented
from repro.segment import min_uniform_depth as jax_min_uniform_depth
from repro_torch import segment
from repro_torch.api import Explorer, ExploreConfig, load_library, spec_for
from repro_torch.api import library as tlib
from repro_torch.api.library import InterpLibrary, LibraryIntegrityError
from repro_torch.segment import segmenter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROM_SHA = "12aa483ae8456c2f"


@pytest.fixture(scope="module")
def jax_lib():
    return default_explorer().compile()


def test_default_kinds_match():
    assert tlib.DEFAULT_LIBRARY_KINDS == tuple(DEFAULT_LIBRARY_KINDS)


@pytest.mark.parametrize("kind", DEFAULT_LIBRARY_KINDS)
def test_vendored_table_equals_reference_design(kind, jax_lib):
    """Each vendored table is the design the reference generator compiles
    into its default library, field for field."""
    path = tlib.TABLES_DIR / f"{kind}_{tlib.DEFAULT_TABLE_KEY}.json"
    vendored = json.loads(path.read_text())
    ref = default_explorer().get_table(kind)
    assert vendored == json.loads(ref.to_json())
    assert jax_lib.meta(kind).name == vendored["name"]


def test_default_library_rom_sha_matches_reference(jax_lib):
    lib = InterpLibrary.default_library("cpu")
    assert lib.rom_sha() == ROM_SHA == jax_lib.rom_sha()
    assert lib.sealed_sha == ROM_SHA
    assert tuple(lib.coeffs.shape) == (8, 64, 3)
    np.testing.assert_array_equal(lib.coeffs.numpy(),
                                  np.asarray(jax_lib.coeffs))
    assert [m.to_dict() for m in lib.metas] == \
        [m.to_dict() for m in jax_lib.metas]
    np.testing.assert_array_equal(lib.meta_rows().numpy(),
                                  np.asarray(jax_lib.meta_rows()))


def test_reference_saved_library_loads_in_port(jax_lib, tmp_path):
    man = jax_lib.save(tmp_path / "ref_lib")
    lib = InterpLibrary.load(man, device="cpu")
    assert lib.rom_sha() == ROM_SHA and lib.sealed_sha == ROM_SHA
    assert lib.kinds == tuple(jax_lib.kinds)
    np.testing.assert_array_equal(lib.coeffs.numpy(),
                                  np.asarray(jax_lib.coeffs))


def test_port_saved_library_loads_in_reference(jax_lib, tmp_path):
    lib = InterpLibrary.default_library("cpu")
    man = lib.save(tmp_path / "port" / "lib")
    ref = JaxLibrary.load(man)
    assert ref.rom_sha() == ROM_SHA
    assert ref.metas == jax_lib.metas
    # the manifests are the same document
    jax_man = json.loads(jax_lib.save(tmp_path / "ref" / "lib").read_text())
    port_man = json.loads(man.read_text())
    assert port_man == jax_man


def test_segmented_manifest_refused(tmp_path):
    """Manifests of version 1 and 2 (segmented slots) load; any other
    version is refused, as the reference refuses it."""
    lib = InterpLibrary.default_library("cpu")
    man = lib.save(tmp_path / "lib")
    doc = json.loads(man.read_text())
    doc["version"] = 2
    man.write_text(json.dumps(doc))
    assert InterpLibrary.load(man, device="cpu").rom_sha() == ROM_SHA
    doc["version"] = 3
    man.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="unsupported library version 3"):
        InterpLibrary.load(man, device="cpu")
    with pytest.raises(ValueError, match="unsupported library version 3"):
        JaxLibrary.load(man)


def test_corrupt_rom_refused_on_load(tmp_path):
    lib = InterpLibrary.default_library("cpu")
    man = lib.save(tmp_path / "lib")
    doc = json.loads(man.read_text())
    doc["coeffs_sha"] = "0" * 16
    man.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="corrupt"):
        InterpLibrary.load(man, device="cpu")


def test_verify_resident_catches_a_flipped_bit():
    lib = InterpLibrary.default_library("cpu")
    assert lib.verify_resident() == ROM_SHA
    lib.coeffs[3, 5, 2] ^= 1 << 7
    with pytest.raises(LibraryIntegrityError):
        lib.verify_resident()


def test_func_id_and_meta_lookup():
    lib = InterpLibrary.default_library("cpu")
    assert lib.func_id("silu") == DEFAULT_LIBRARY_KINDS.index("silu")
    assert lib.meta("rsqrt").out_bits == 13
    with pytest.raises(KeyError):
        lib.func_id("relu")
    assert torch.equal(lib.meta_rows()[lib.func_id("silu")],
                       torch.tensor(lib.meta("silu").datapath_row(),
                                    dtype=torch.int32))


def test_contains_matches_reference(jax_lib):
    """``kind in lib`` is True exactly for the library's kinds, as the
    reference's ``InterpLibrary.__contains__``."""
    lib = InterpLibrary.default_library("cpu")
    for kind in (*DEFAULT_LIBRARY_KINDS, "no_such_kind", "Silu", ""):
        assert (kind in lib) == (kind in jax_lib)
    assert "silu" in lib and "no_such_kind" not in lib
    assert all(kind in lib for kind in lib.kinds)


# -- ROM v2: segmented slots in the library artifact --------------------------

SEG_ROM_SHA = "f775a828748d4ea9"  # the default manifest, segmented


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    """The mixed library of both packages (tanh segmented at 8 bits beside
    the uniform sigmoid), its tanh design in both, and a port Explorer on
    a fresh cache."""
    spec, jspec = spec_for("tanh", 8), jax_spec_for("tanh", 8)
    r = segment.min_uniform_depth(spec, engine="batched", device="cpu")
    assert r == jax_min_uniform_depth(jspec, engine="batched")
    sd = segment.explore_segmented(spec, max_depth=r, engine="batched",
                                   device="cpu")
    jsd = jax_explore_segmented(jspec, max_depth=r, engine="batched")
    assert sd is not None and jsd is not None
    ex = Explorer(ExploreConfig(device="cpu",
                                cache_dir=str(tmp_path_factory.mktemp("v2"))))
    lib = InterpLibrary.from_designs([sd, ex.get_table("sigmoid")],
                                     ["tanh", "sigmoid"], device="cpu")
    jlib = JaxLibrary.from_designs(
        [jsd, default_explorer().get_table("sigmoid")], ["tanh", "sigmoid"])
    return lib, jlib, sd, jsd, ex


def _all_codes(lib, kind):
    return torch.arange(1 << lib.meta(kind).in_bits, dtype=torch.int32)


def test_v2_segmented_slot_evaluates_bitwise(v2):
    lib, jlib, sd, jsd, _ = v2
    codes = _all_codes(lib, "tanh")
    got = lib.eval_int(codes, "tanh").numpy().astype(np.int64)
    np.testing.assert_array_equal(got, sd.eval_int(codes.numpy()))
    np.testing.assert_array_equal(got, jsd.eval_int(codes.numpy()))
    np.testing.assert_array_equal(got, np.asarray(
        jlib.eval_int(jnp.asarray(codes.numpy()), "tanh"), np.int64))


def test_v2_mixed_library_saves_as_v2_and_round_trips(v2, tmp_path):
    lib, jlib, *_ = v2
    assert lib.manifest() == jlib.manifest()
    assert lib.manifest()["version"] == 2
    assert lib.segmented_kinds == tuple(jlib.segmented_kinds) == ("tanh",)
    assert lib.rom_sha() == jlib.rom_sha()
    back = load_library(lib.save(tmp_path / "lib"), device="cpu")
    assert back.metas == lib.metas
    assert torch.equal(back.coeffs, lib.coeffs)
    for kind in ("tanh", "sigmoid"):  # the uniform neighbour is untouched
        codes = _all_codes(back, kind)
        assert torch.equal(back.eval_int(codes, kind),
                           lib.eval_int(codes, kind))
    ref = JaxLibrary.load(tmp_path / "lib.json")
    assert ref.rom_sha() == lib.rom_sha() and ref.metas == jlib.metas


def test_v2_uniform_library_still_saves_v1_checksum_identical(v2, tmp_path):
    """An all-uniform library's manifest stays version 1 with no segment
    keys, and its content-addressed ROM file name is the reference's."""
    *_, ex = v2
    lib = ex.compile()
    assert lib.segmented_kinds == ()
    man = lib.manifest()
    assert man["version"] == 1
    for entry in man["funcs"]:
        assert "seg_depth" not in entry and "seg_meta" not in entry
    m1, m2 = (json.loads(lib.save(tmp_path / d / "lib").read_text())
              for d in ("a", "b"))
    jm = json.loads(default_explorer().compile().save(
        tmp_path / "ref" / "lib").read_text())
    assert m1["coeffs_file"].split(".")[1] == m2["coeffs_file"].split(".")[1]
    assert m1 == m2 == jm
    back = load_library(tmp_path / "a" / "lib.json", device="cpu")
    assert torch.equal(back.coeffs, lib.coeffs)


def test_v2_eval_fused_serves_segmented_slots(v2):
    """One fused call over mixed uniform and segmented ids equals the
    per-kind entry points and the reference's interpret-mode walk."""
    lib, jlib, sd, *_ = v2
    codes_t, codes_s = _all_codes(lib, "tanh"), _all_codes(lib, "sigmoid")
    codes = torch.cat([codes_t, codes_s])
    fids = torch.cat([torch.full_like(codes_t, lib.func_id("tanh")),
                      torch.full_like(codes_s, lib.func_id("sigmoid"))])
    got = lib.eval_fused(codes, fids).numpy().astype(np.int64)
    want = np.concatenate([lib.eval_int(codes_t, "tanh").numpy(),
                           lib.eval_int(codes_s, "sigmoid").numpy()])
    np.testing.assert_array_equal(got, want)
    jc, jf = jnp.asarray(codes.numpy()), jnp.asarray(fids.numpy())
    for use_kernel in (False, True):
        np.testing.assert_array_equal(got, np.asarray(jlib.eval_fused(
            jc, jf, use_kernel=use_kernel, interpret=True), np.int64))
    np.testing.assert_array_equal(
        lib.eval_fused(codes_t, lib.func_id("tanh")).numpy(),
        sd.eval_int(codes_t.numpy()))


def test_v2_compile_segmented_swaps_only_improving_slots(v2):
    *_, ex = v2
    lib_u, lib_s = ex.compile(), ex.compile_segmented()
    assert lib_s.rom_sha() == SEG_ROM_SHA
    assert set(lib_s.kinds) == set(lib_u.kinds)
    assert (sum(m.rows_used for m in lib_s.metas)
            < sum(m.rows_used for m in lib_u.metas))
    for kind in lib_s.kinds:
        mu, ms = lib_u.meta(kind), lib_s.meta(kind)
        if ms.seg_depth:
            assert ms.rows_used < mu.rows_used
        else:
            assert ms == mu


def test_v2_explore_segmented_reexported_identity():
    assert segment.explore_segmented is segmenter.explore_segmented
