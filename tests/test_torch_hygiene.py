"""Import hygiene and device discipline of the PyTorch port.

``repro_torch`` must import neither ``jax`` nor anything of ``repro``, and
every entry point asked for ``"cuda"`` where there is no card must raise
rather than run on the CPU.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.api import InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.device import resolve

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
# modules the hygiene walk must reach (the MoE slice's among them)
REQUIRED = ("repro_torch.configs.deepseek_moe_16b", "repro_torch.models.moe",
            "repro_torch.kernels.softmax.kernel",
            "repro_torch.kernels.softmax.ops",
            "repro_torch.kernels.softmax.ref", "repro_torch.serve.engine",
            # the generator slice's
            "repro_torch.api.explorer", "repro_torch.core.fleet",
            "repro_torch.core.batched", "repro_torch.kernels.dspace.kernel",
            "repro_torch.kernels.dspace.ops",
            "repro_torch.kernels.dspace.ref",
            # the segmentation slice's
            "repro_torch.segment", "repro_torch.segment.tree",
            "repro_torch.segment.design", "repro_torch.segment.decide",
            "repro_torch.segment.segmenter", "repro_torch.segment.cost",
            # the per-table slice's
            "repro_torch.numerics.registry", "repro_torch.kernels.flashattn.ops",
            "repro_torch.kernels.rmsnorm.ops",
            # the serving control layer's
            "repro_torch.numerics.guard", "repro_torch.util",
            "repro_torch.util.journal", "repro_torch.serve.journal",
            "repro_torch.faults", "repro_torch.faults.inject",
            # the plans / AOT / host pipeline slice's
            "repro_torch.plan", "repro_torch.plan.schema",
            "repro_torch.plan.numerics", "repro_torch.plan.assign",
            "repro_torch.dse", "repro_torch.dse.record",
            "repro_torch.dse.probe", "repro_torch.serve.aot",
            "repro_torch.serve.pipeline",
            # the decoder families' (MLA, sliding window, QKV bias, relu2)
            "repro_torch.configs.minicpm3_4b",
            "repro_torch.configs.mixtral_8x22b",
            "repro_torch.configs.qwen1_5_110b",
            "repro_torch.configs.minitron_8b",
            "repro_torch.models.attention", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.convert",
            # the training and checkpoint slice's
            "repro_torch.data", "repro_torch.data.synthetic",
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.schedule", "repro_torch.optim.compress",
            "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
            "repro_torch.train", "repro_torch.train.step",
            "repro_torch.train.trainer", "repro_torch.launch.train",
            "repro_torch.util.tree",
            # the DSE slice's, with the legacy shims and the Remez baseline
            "repro_torch.dse.trial", "repro_torch.dse.space",
            "repro_torch.dse.store", "repro_torch.dse.frontier",
            "repro_torch.dse.study", "repro_torch.launch.dse",
            "repro_torch.core.generate", "repro_torch.core.remez")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: 'cuda' is a valid device here")


def test_import_hygiene_no_jax_no_repro():
    """A fresh interpreter imports repro_torch and every submodule; neither
    jax nor any repro module may be loaded afterwards."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        f"missing = sorted(set({REQUIRED!r}) - set(names))\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _serve_cli(arch="yi_6b"):
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--smoke", "--requests", "1"])


def _engine():
    from repro_torch.serve.engine import ServeEngine

    cfg = get_smoke_config("yi_6b")
    ServeEngine(cfg, {}, slots=1, cache_len=8)


def _init_params():
    from repro_torch.models import transformer as tf

    tf.init_params(get_smoke_config("yi_6b"))


def _init_cache():
    from repro_torch.models import transformer as tf

    tf.init_cache(get_smoke_config("yi_6b"), 1, 8)


def _convert():
    from repro_torch.convert import params_from_jax

    params_from_jax({}, get_smoke_config("yi_6b"))


def _load(tmp_path):
    lib = InterpLibrary.default_library("cpu")
    InterpLibrary.load(lib.save(tmp_path / "lib"))


def _from_designs():
    from repro_torch.core.table import CoeffMeta, TableDesign

    meta = CoeffMeta(8, 0, True)
    d = TableDesign("t", 4, 4, 2, 0, 1, 0, 0, np.zeros(4, np.int64),
                    np.zeros(4, np.int64), np.zeros(4, np.int64), meta, meta,
                    meta)
    InterpLibrary.from_designs([d], ["silu"])


def _explore_pallas(tmp):
    from repro_torch.api import Explorer, ExploreConfig, get_spec

    Explorer(ExploreConfig(engine="pallas", cache_dir=str(tmp))).explore(
        get_spec("recip", 8))


def _compile_mesh(tmp):
    from repro_torch.api import Explorer, ExploreConfig

    Explorer(ExploreConfig(mesh=2, cache_dir=str(tmp))).compile(["recip"])


def _region_envelopes():
    from repro_torch.core.funcspec import get_spec
    from repro_torch.kernels.dspace.ops import region_envelopes_device

    region_envelopes_device(*get_spec("recip", 8).region_bounds(3))


def _device_coeffs():
    from repro_torch.core.table import CoeffMeta, TableDesign

    meta = CoeffMeta(8, 0, True)
    TableDesign("t", 4, 4, 2, 0, 1, 0, 0, np.zeros(4, np.int64),
                np.zeros(4, np.int64), np.zeros(4, np.int64), meta, meta,
                meta).device_coeffs()


def _compile_segmented(tmp):
    from repro_torch.api import Explorer, ExploreConfig

    Explorer(ExploreConfig(cache_dir=str(tmp))).compile_segmented(["recip"])


def _explore_segmented_pallas():
    from repro_torch.core.funcspec import get_spec
    from repro_torch.segment import explore_segmented

    explore_segmented(get_spec("recip", 8), engine="pallas")


def _plan_libraries():
    from repro_torch.plan import NumericsPlan
    from repro_torch.plan.numerics import compile_plan_libraries

    compile_plan_libraries(NumericsPlan.uniform("interp-fused", 2))


def _plan_numerics():
    from repro_torch.numerics.ops import get_numerics
    from repro_torch.plan import NumericsPlan

    get_numerics(get_smoke_config("yi_6b").replace(
        plan=NumericsPlan.uniform("interp-fused", 2)))


def _train_state_init():
    from repro_torch.train import train_state_init

    train_state_init(get_smoke_config("yi_6b"))


def _trainer(tmp):
    from repro_torch.train import Trainer, TrainerConfig

    Trainer(get_smoke_config("yi_6b"), TrainerConfig(ckpt_dir=str(tmp)))


def _train_cli(tmp):
    from repro_torch.launch.train import main

    main(["--arch", "yi_6b", "--smoke", "--steps", "1", "--ckpt-dir",
          str(tmp)])


def _study(tmp):
    from repro_torch.dse import Study, smoke_space

    Study(tmp / "study", smoke_space())


def _serve_probe():
    from repro_torch.dse import ServeProbe

    ServeProbe()


def _dse_cli(tmp):
    from repro_torch.launch.dse import main

    main(["run", "--study", str(tmp / "study"), "--preset", "smoke"])


def _dse_plan_cli():
    from repro_torch.launch.dse import main

    main(["plan", "--arch", "yi_6b", "--smoke"])


ENTRY_POINTS = {
    "explore_pallas": _explore_pallas,
    "compile_mesh": _compile_mesh,
    "compile_segmented": _compile_segmented,
    "explore_segmented_pallas": lambda tmp: _explore_segmented_pallas(),
    "region_envelopes_device": lambda tmp: _region_envelopes(),
    "device_coeffs": lambda tmp: _device_coeffs(),
    "resolve": lambda tmp: resolve("cuda"),
    "default_library": lambda tmp: InterpLibrary.default_library(),
    "from_designs": lambda tmp: _from_designs(),
    "load": _load,
    "init_params": lambda tmp: _init_params(),
    "init_cache": lambda tmp: _init_cache(),
    "params_from_jax": lambda tmp: _convert(),
    "serve_engine": lambda tmp: _engine(),
    "serve_cli": lambda tmp: _serve_cli(),
    "serve_cli_moe": lambda tmp: _serve_cli("deepseek_moe_16b"),
    "compile_plan_libraries": lambda tmp: _plan_libraries(),
    "plan_get_numerics": lambda tmp: _plan_numerics(),
    "train_state_init": lambda tmp: _train_state_init(),
    "trainer": _trainer,
    "train_cli": _train_cli,
    "dse_study": _study,
    "serve_probe": lambda tmp: _serve_probe(),
    "dse_cli": _dse_cli,
    "dse_plan_cli": lambda tmp: _dse_plan_cli(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_asked_for_cuda_raises(name, tmp_path, no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name](tmp_path)


def test_kernel_build_raises_without_nvcc(monkeypatch, no_card):
    """A CUDA wrapper never degrades to its plain version: without the
    toolkit the build itself raises."""
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(build, "BUILD_DIR", pathlib.Path("/nonexistent"))
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("the CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_serve_cli_smoke_on_cpu(arch, capsys):
    """``--smoke --device cpu`` serves the reduced config through the plain
    versions: every request completes and no kernel launches."""
    import json

    from repro_torch.launch.serve import main

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
              "3", "--max-new", "4"])
    finally:
        torch.set_num_threads(n)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu" and report["tokens"] == 12
    assert set(report["stats"]["launches"].values()) == {0}
