"""The port's dry run and roofline (``repro_torch.launch.{inputs, dryrun,
roofline}``, ``configs.base.ShapeConfig`` / ``SHAPES`` /
``cell_is_runnable``) against the JAX package.

The reference's own dry run fails on the installed jax (``ValueError: The
spec of NamedSharding passed to with_sharding_constraint can only refer
to Auto axes of the mesh``, ROADMAP queue 3), so whole records are not
compared; the pieces are:

* ``SHAPES`` and ``cell_is_runnable`` equal for the 10 archs x 4 shapes;
* ``input_specs`` / ``batch_shapes`` shapes and dtypes equal to the
  reference's ``ShapeDtypeStruct`` s for the full configs (the cache's
  layout is the port's own: its total bytes are the reference's);
* ``param_counts`` and ``model_flops`` exactly equal for all ten;
* ``cell_roofline`` on a record equals the formula with the H100
  constants;
* ``run_cell`` for every arch at ``decode_32k`` and ``train_4k`` on
  ``pod16x16`` traces ``ok``, and ``long_500k`` takes the reference's skip
  reason for the seven archs that are not sub-quadratic.
"""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import inputs as jinputs
from repro.launch import roofline as jroof
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troof
from repro_torch.util.tree import tree_leaves

ARCHS = tbase.ARCH_IDS
_DT = {"int32": torch.int32, "float32": torch.float32,
       "bfloat16": torch.bfloat16}


def test_arch_ids_and_shapes_equal():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert list(tbase.SHAPES) == list(jbase.SHAPES)
    for name, s in tbase.SHAPES.items():
        r = jbase.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            r.name, r.seq_len, r.global_batch, r.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_is_runnable_equal(arch):
    for name in tbase.SHAPES:
        assert tbase.cell_is_runnable(tbase.get_config(arch),
                                      tbase.SHAPES[name]) == \
            jbase.cell_is_runnable(jbase.get_config(arch),
                                   jbase.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal(arch):
    """Every input but the cache leaf for leaf (shape and dtype); the
    cache in the port's layout holds the reference's bytes."""
    cfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    for name in tbase.SHAPES:
        got = tinputs.input_specs(cfg, tbase.SHAPES[name])
        want = jinputs.input_specs(jcfg, jbase.SHAPES[name])
        assert sorted(got) == sorted(want)
        for key in got:
            if key == "caches":
                tb = sum(math.prod(s.shape) * s.dtype.itemsize
                         for s in tree_leaves(got[key]))
                import jax

                jb = sum(math.prod(s.shape) * s.dtype.itemsize
                         for s in jax.tree.leaves(want[key]))
                assert tb == jb, (arch, name)
                continue
            g, w = got[key], want[key]
            if isinstance(g, dict):
                assert sorted(g) == sorted(w)
                for k in g:
                    assert tuple(g[k].shape) == tuple(w[k].shape)
                    assert g[k].dtype == _DT[str(w[k].dtype)]
            else:
                assert tuple(g.shape) == tuple(w.shape), (arch, name, key)
                assert g.dtype == _DT[str(w.dtype)], (arch, name, key)
    b = tinputs.batch_shapes(cfg, 4, 16)
    jb = jinputs.batch_shapes(jcfg, 4, 16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == {
        k: (tuple(v.shape), _DT[str(v.dtype)]) for k, v in jb.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal(arch):
    cfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    assert troof.param_counts(cfg) == jroof.param_counts(jcfg)
    assert troof._n_moe_layers(cfg) == jroof._n_moe_layers(jcfg)
    for name, shape in tbase.SHAPES.items():
        assert troof.model_flops(cfg, shape, shape.kind) == \
            jroof.model_flops(jcfg, jbase.SHAPES[name], shape.kind)


def test_cell_roofline_is_the_formula_with_the_card_constants():
    prof = {"flops": 3.0e11, "hbm_bytes": 7.0e9,
            "total_collective_bytes": 2.0e7}
    rec = {"arch": "yi_6b", "shape": "decode_32k", "mesh": "pod16x16",
           "status": "ok", "profile": prof, "memory": {"temp_bytes": 5}}
    r = troof.cell_roofline(rec)
    assert r["compute_s"] == 3.0e11 / 989e12
    assert r["memory_s"] == 7.0e9 / 3.35e12
    assert r["collective_s"] == 2.0e7 / 50e9
    assert r["dominant"] == "memory"
    useful = troof.model_flops(tbase.get_config("yi_6b"),
                               tbase.SHAPES["decode_32k"], "decode")
    assert r["useful_ratio"] == useful / 256 / 3.0e11
    assert r["roofline_frac"] == (useful / 256 / 989e12) / r["memory_s"]
    # the card's constants, never the reference's TPU figures
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NET_BW) == (
        989e12, 3.35e12, 50e9)
    assert troof.cell_roofline({"status": "skipped"}) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_decode_and_train_trace_ok(arch):
    """Both cells trace on the (16, 16) mesh: per-rank profile and memory
    in the reference's record schema; the train cell's state is this
    rank's ZeRO-3 x Megatron shard."""
    for name in ("decode_32k", "train_4k"):
        rec = dryrun.run_cell(arch, name)
        assert rec["status"] == "ok", rec.get("traceback", rec)
        assert rec["mesh"] == "pod16x16" and rec["compile_s"] is None
        assert rec["xla_cost_flops"] is None
        prof, mem = rec["profile"], rec["memory"]
        assert set(prof) >= {"flops", "hbm_bytes", "collective_bytes",
                             "collective_count", "total_collective_bytes",
                             "trip_counts"}
        assert prof["flops"] > 0 and prof["hbm_bytes"] > 0
        assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
        assert prof["trip_counts"] == [
            s.repeat for s in __import__(
                "repro_torch.models.transformer",
                fromlist=["layer_plan"]).layer_plan(tbase.get_config(arch))
            if s.repeat > 1]
        if name == "train_4k":  # ZeRO-3: gathers and reduce-scatters
            assert prof["collective_count"].get("reduce_scatter", 0) > 0
            assert prof["collective_count"].get("all_gather", 0) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_skips_as_the_reference(arch):
    rec = dryrun.run_cell(arch, "long_500k")
    ok, why = jbase.cell_is_runnable(jbase.get_config(arch),
                                     jbase.SHAPES["long_500k"])
    if ok:
        assert arch in ("mixtral_8x22b", "mamba2_130m", "jamba_v0_1_52b")
        assert rec["status"] == "ok"
    else:
        assert rec == {"arch": arch, "shape": "long_500k",
                       "mesh": "pod16x16", "tag": "", "status": "skipped",
                       "reason": why}


def test_main_and_roofline_report(tmp_path, capsys):
    """One cell through the CLI (its record and op breakdown written),
    then the roofline's markdown row for it."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2_130m", "--shape", "decode_32k",
                     "--multi-pod", "--save-ops", "--out", str(tmp_path)])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "done: 1 ok, 0 skipped, 0 errors" in out
    rec = json.loads((tmp_path / "mamba2_130m_decode_32k_pod2x16x16.json")
                     .read_text())
    assert rec["status"] == "ok"
    ops = json.loads((tmp_path / "mamba2_130m_decode_32k_pod2x16x16.ops.json")
                     .read_text())["ops"]
    assert ops and {"op", "where", "bytes", "flops"} <= set(ops[0])
    troof.main(["--dir", str(tmp_path), "--md"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("| arch | shape | mesh | compute |")
    row = [ln for ln in lines if ln.startswith("| mamba2_130m |")]
    assert len(row) == 1 and "pod2x16x16" in row[0]
    r = troof.cell_roofline(rec)
    np.testing.assert_allclose(r["memory_s"],
                               rec["profile"]["hbm_bytes"] / 3.35e12)


# ---------------------------------------------------------------------------
# the port's own records
# ---------------------------------------------------------------------------

def _reference_record() -> dict:
    """A record in the reference dry run's schema (its keys, no package
    stamp), its profile from the reference's ``analyze_hlo`` of a small
    compiled step on the CPU (the reference's own dry run does not lower
    on the installed jax)."""
    import jax
    import jax.numpy as jnp

    from repro.launch.xprof import analyze_hlo

    hlo = jax.jit(lambda x: jnp.tanh(x @ x)).lower(
        jnp.ones((64, 64), jnp.float32)).compile().as_text()
    return {"arch": "yi_6b", "shape": "decode_32k", "mesh": "pod16x16",
            "tag": "", "status": "ok", "lower_s": 0.1, "compile_s": 0.2,
            "memory": {"argument_bytes": 16384, "output_bytes": 16384,
                       "temp_bytes": 0, "generated_code_bytes": 0},
            "xla_cost_flops": 0.0, "xla_cost_bytes": 0.0,
            "profile": analyze_hlo(hlo).to_dict()}


@pytest.fixture(scope="module")
def own_records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_torch")
    rec = dryrun.run_cell("mamba2_130m", "decode_32k", out_dir=d)
    return d, rec


def test_dry_run_directory_is_the_ports_own():
    """The port's dry run and roofline default to ``artifacts/dryrun_torch``,
    not the reference's ``artifacts/dryrun``."""
    from repro.launch import dryrun as jdryrun

    assert dryrun.DEFAULT_OUT != jdryrun.DEFAULT_OUT
    assert dryrun.DEFAULT_OUT.parent == jdryrun.DEFAULT_OUT.parent
    assert dryrun.DEFAULT_OUT.name == "dryrun_torch"
    assert troof.DEFAULT_DIR == dryrun.DEFAULT_OUT


def test_own_records_round_trip(own_records):
    """What ``run_cell`` returns, stamped ``"package": "repro_torch"``, is
    what ``load_records`` reads back."""
    d, rec = own_records
    want = json.loads(json.dumps({**rec, "package": "repro_torch"},
                                 default=str))
    assert rec["status"] == "ok"
    assert troof.load_records(d) == [want]


def test_roofline_skips_a_reference_record(own_records, tmp_path, capsys):
    """A reference record placed in the port's directory is skipped (and
    counted on stderr): the roofline reads the port's cell alone."""
    d, _rec = own_records
    for f in d.glob("*.json"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    (tmp_path / "yi_6b_decode_32k_pod16x16.json").write_text(
        json.dumps(_reference_record(), indent=1))
    capsys.readouterr()
    got = troof.load_records(tmp_path)
    assert [(r["arch"], r["package"]) for r in got] == [
        ("mamba2_130m", "repro_torch")]
    assert "skipped 1 record(s)" in capsys.readouterr().err
    troof.main(["--dir", str(tmp_path)])
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 1 and rows[0].startswith("mamba2_130m")
