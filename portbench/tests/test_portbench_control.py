"""The control of the correctness check: the reference put in the
program's place with fp8 weights (one scale per output column), its
greedy tokens judged by the run's own ``judge``. At smoke size on the CPU
it reads gaps that the float32 program does not; on the card (``-m gpu``)
``readings.py`` at each cell's own size, on three seeds, has ``judge``
pass the program and fail the control under the cell's limits."""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from portbench import run as R, weights
from portbench.reference import model
from portbench.tests.conftest import cell_limits, smoke

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_fp8_columns_round_each_column_to_its_scale():
    w = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
    q = model.fp8_columns(w)
    assert q.shape == w.shape and not torch.equal(q, w)
    rel = ((q - w).abs() / w.abs().amax(0)).max()
    assert 0 < rel <= 2 ** -4  # 3 mantissa bits, the column's own scale
    assert torch.equal(q.abs().amax(0), w.abs().amax(0))


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_control_reads_above_the_program(arch):
    c, _ = smoke(arch)
    tree = weights.make(c, 2_147_483_777, "cpu")
    g = torch.Generator().manual_seed(1)
    sample = []
    for n in (9, 14, 20, 27, 33, 38):
        prompt = torch.randint(0, c["vocab_size"], (n,), generator=g)
        out: list[int] = []
        for _ in range(24):  # the reference's own greedy tokens
            ids = torch.cat([prompt, torch.tensor(out, dtype=torch.long)])
            lg = model.logits(tree, c, [{"ids": ids, "prompt": n,
                                         "cap_len": n}])[0]
            out.append(int(lg[-1].argmax()))
        sample.append({"rid": n, "prompt": prompt.tolist(), "out": out,
                       "max_new": 24, "cap_len": n})
    cell = {"check": {"limits": cell_limits(arch)}}
    v = R.judge(tree, c, cell, sample, "cpu", control=True)
    assert v["correct"] and v["max_gap"] == 0.0
    assert v["control"]["rows"] == v["rows"]
    assert v["control"]["max_gap"] > 0.0 and v["control"]["mean_gap"] > 0.0


CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "readings.py"),
         "--workload", cell, "--seeds", "3", "--seconds", "8"],
        capture_output=True, text=True, check=True, cwd=ROOT)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["seeds"] == 3
    assert last["program_correct"] == 3 and last["control_correct"] == 0
    for k, limit in last["limits"].items():
        assert last[k]["program_max"] <= limit < last[k]["control_min"]
