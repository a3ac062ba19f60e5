"""Checkpoints in both directions: the port's ``repro_torch.checkpoint``
against the reference's ``repro.checkpoint`` on one layout (``step_%09d/``,
``arr_%05d.npy`` per leaf, ``manifest.json``, ``LATEST``), and the train
state carried across by ``convert.train_state_from_jax`` / ``to_numpy``.

The states are ``yi_6b`` smoke train states in bf16 (float32 optimizer
state, an int32 step, the compression residual): the reference's ``save``
read by the port bitwise, the port's read by the reference's ``restore``
bitwise, the two manifests (names, order, shapes, dtypes, checksums) and
leaf files byte for byte equal; then keep-K, a pointer ahead of its data,
a crashed writer's stray directory, a corrupt leaf, and an
``InterpLibrary`` inside a state (saved as its ``coeffs`` leaf).
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.train.step import StepConfig as JStepConfig
from repro.train.step import train_state_init as jax_train_state_init
from repro_torch import checkpoint as ckpt
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import to_numpy, train_state_from_jax
from repro_torch.train.step import StepConfig, train_state_shapes
from repro_torch.util.tree import leaves_with_paths


@pytest.fixture(scope="module")
def states():
    jcfg = jax_smoke_config("yi_6b").replace(param_dtype="bfloat16")
    cfg = get_smoke_config("yi_6b").replace(param_dtype="bfloat16")
    jstate = jax_train_state_init(jax.random.key(0), jcfg,
                                  JStepConfig(compress_pods=True))
    # a state past step 0: nonzero moments, a step counter of 7
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jax.numpy.asarray(7, jax.numpy.int32),
        mu=jax.tree.map(lambda x: x + 0.25, jstate.opt.mu)))
    jnp_state = jax.tree.map(np.asarray, jstate)
    return dict(jcfg=jcfg, cfg=cfg, jstate=jstate, jnp_state=jnp_state,
                state=train_state_from_jax(jnp_state, cfg, "cpu"),
                sc=StepConfig(compress_pods=True))


def _as_np(t) -> np.ndarray:
    """A leaf's bits as numpy: bf16 through its uint16 view."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bitwise(got, want):
    g, w = leaves_with_paths(got), leaves_with_paths(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        a, b = _as_np(a), _as_np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_reference_checkpoint_reads_bitwise(states, tmp_path):
    jckpt.save(tmp_path, 7, states["jstate"], {"note": "ref"})
    assert ckpt.latest_step(tmp_path) == 7
    like = train_state_shapes(states["cfg"], states["sc"])
    got, extra = ckpt.restore(tmp_path, 7, like)
    assert extra == {"note": "ref"}
    assert got.params["embed"]["tok"].dtype == torch.bfloat16
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 7
    _assert_bitwise(got, states["jnp_state"])
    _assert_bitwise(got, states["state"])  # = train_state_from_jax


def test_port_checkpoint_reads_bitwise_in_the_reference(states, tmp_path):
    ckpt.save(tmp_path, 3, states["state"], {"by": "port"})
    assert jckpt.latest_step(tmp_path) == 3
    got, extra = jckpt.restore(tmp_path, 3, states["jstate"])
    assert extra == {"by": "port"}
    assert got.params["embed"]["tok"].dtype.name == "bfloat16"
    _assert_bitwise(got, states["jnp_state"])


def test_manifests_and_files_equal(states, tmp_path):
    """Both packages write the same state to the same bytes: manifest
    entries (name, file, shape, logical dtype, sha256[:16]) in the same
    order, and every leaf file."""
    ref = jckpt.save(tmp_path / "ref", 1, states["jstate"])
    port = ckpt.save(tmp_path / "port", 1, states["state"])
    jm = json.loads((ref / "manifest.json").read_text())
    m = json.loads((port / "manifest.json").read_text())
    assert m == jm
    assert [e["name"] for e in m["leaves"]][:2] == ["params/embed/head",
                                                   "params/embed/tok"]
    assert {e["dtype"] for e in m["leaves"]} == {"bfloat16", "float32",
                                                 "int32"}
    for e in m["leaves"]:
        assert (port / e["file"]).read_bytes() == \
            (ref / e["file"]).read_bytes(), e["name"]


def test_round_trip_through_both_checkpoints(states, tmp_path):
    """reference state -> numpy -> port state -> port save -> reference
    restore -> reference save -> port restore -> ``to_numpy``: the
    original state's bits at every stage."""
    ckpt.save(tmp_path / "a", 0, states["state"])
    jgot, _ = jckpt.restore(tmp_path / "a", 0, states["jstate"])
    jckpt.save(tmp_path / "b", 0, jgot)
    got, _ = ckpt.restore(tmp_path / "b", 0, states["state"])
    back = to_numpy(got)
    assert back.params["embed"]["tok"].dtype.name == "bfloat16"
    _assert_bitwise(back, states["jnp_state"])
    # the numpy state starts the reference again
    again = jax.tree.map(jax.numpy.asarray, back)
    _assert_bitwise(jax.tree.map(np.asarray, again), states["jnp_state"])


def test_keep_k_and_latest(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), every=1, keep=2)
    tree = {"w": torch.zeros(3)}
    for s in range(5):
        assert mgr.maybe_save(s, tree)
    assert not ckpt.CheckpointManager(str(tmp_path), every=2).maybe_save(
        3, tree)
    kept = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_"))
    assert kept == ["step_000000003", "step_000000004"]
    assert ckpt.latest_step(tmp_path) == 4
    s, got, _ = mgr.restore_latest(tree)
    assert s == 4 and torch.equal(got["w"], tree["w"])
    assert ckpt.CheckpointManager(str(tmp_path / "none")).restore_latest(
        tree) == (None, None, None)


def test_torn_latest_and_stray_writer(tmp_path):
    """A pointer ahead of its data is no checkpoint; a crashed writer's
    ``.tmp`` directory is never read and the next save's GC removes it."""
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    ckpt.save(tmp_path, 2, tree)
    (tmp_path / "LATEST").write_text("9")  # no step_000000009 yet
    assert ckpt.latest_step(tmp_path) is None
    assert jckpt.latest_step(tmp_path) is None
    stray = tmp_path / "step_000000010.tmp"
    stray.mkdir()
    (stray / "arr_00000.npy").write_bytes(b"torn")
    mgr = ckpt.CheckpointManager(str(tmp_path), every=1, keep=3)
    mgr.maybe_save(3, tree)
    assert ckpt.latest_step(tmp_path) == 3 and not stray.exists()
    got, _ = ckpt.restore(tmp_path, 2, tree)
    assert torch.equal(got["w"], tree["w"])


def test_corrupt_leaf_and_wrong_shape(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16) * 1.5}}
    ckpt.save(tmp_path, 7, tree)
    got, _ = ckpt.restore(tmp_path, 7, tree)
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, 7, {"a": torch.zeros(3, 2),
                                   "b": {"c": torch.zeros(4)}})
    f = tmp_path / "step_000000007" / "arr_00000.npy"
    np.save(f, np.load(f) + 1)
    with pytest.raises(ValueError, match="corrupt leaf a"):
        ckpt.restore(tmp_path, 7, tree)
    with pytest.raises(AssertionError, match="corrupt"):
        jckpt.restore(tmp_path, 7, jax.tree.map(
            lambda t: np.asarray(t.float()), tree))


def test_library_inside_a_state(tmp_path):
    """An ``InterpLibrary`` is one leaf, ``<path>/coeffs``, in both
    packages: each reads the other's, and the port rebuilds the library
    with the restored ROM (same ``rom_sha``)."""
    lib = InterpLibrary.default_library("cpu")
    jlib = default_explorer().compile()
    tree = {"w": torch.ones(2, 2), "lib": lib}
    jtree = {"w": jax.numpy.ones((2, 2)), "lib": jlib}
    ckpt.save(tmp_path / "port", 0, tree)
    names = [e["name"] for e in json.loads(
        (tmp_path / "port" / "step_000000000" / "manifest.json").read_text()
    )["leaves"]]
    assert names == ["lib/coeffs", "w"]
    jgot, _ = jckpt.restore(tmp_path / "port", 0, jtree)
    np.testing.assert_array_equal(np.asarray(jgot["lib"].coeffs),
                                  np.asarray(jlib.coeffs))
    jckpt.save(tmp_path / "ref", 0, jtree)
    got, _ = ckpt.restore(tmp_path / "ref", 0, tree)
    assert isinstance(got["lib"], InterpLibrary)
    assert got["lib"].rom_sha() == lib.rom_sha()
    assert got["lib"].kinds == lib.kinds
