"""The port's InterpLibrary against the reference's: vendored tables, ROM
checksum, and the shared npz + json artifact format in both directions."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.api import DEFAULT_LIBRARY_KINDS, default_explorer
from repro.api.library import InterpLibrary as JaxLibrary
from repro_torch.api import library as tlib
from repro_torch.api.library import InterpLibrary, LibraryIntegrityError


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
