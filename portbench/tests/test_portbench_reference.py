"""The float32 reference against ``repro_torch`` at smoke size, for both
configurations: the prompt's last row from a prefill and then each decode
row through the cache, MoE capacity drops included; and a whole harness
run on the CPU judged correct."""
from __future__ import annotations

import ast
import pathlib

import pytest
import torch

from portbench import weights
from portbench.reference import model
from portbench.tests.conftest import smoke


def program_rows(tree, p, ids, prompt, numerics):
    """The program's logits of every row from the prompt's last on."""
    from repro_torch.models import transformer as tf

    out = []
    with torch.no_grad():
        lg, cache = tf.prefill(tree, ids[None, :prompt], p, numerics, 64)
        out.append(lg[0, 0])
        for pos in range(prompt, len(ids)):
            lg, cache = tf.decode_step(tree, ids[None, pos:pos + 1],
                                       torch.tensor([pos], dtype=torch.int32),
                                       cache, p, numerics)
            out.append(lg[0, 0])
    return torch.stack(out)


def numerics_of(p, name):
    from repro_torch.api.library import InterpLibrary
    from repro_torch.numerics.ops import get_numerics

    p = p.replace(numerics=name)
    lib = None if name == "exact" else InterpLibrary.default_library("cpu")
    return get_numerics(p, lib, fused=name != "exact")


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
@pytest.mark.parametrize("prompt,total", [(5, 9), (23, 30), (40, 41)])
@pytest.mark.parametrize("name,tol", [("exact", 2e-5), ("interp-fused", 2e-2)])
def test_reference_equals_the_program(arch, prompt, total, name, tol):
    c, p = smoke(arch)
    tree = weights.make(c, 2_147_483_701 + prompt, "cpu")
    ids = torch.randint(0, c["vocab_size"], (total,),
                        generator=torch.Generator().manual_seed(prompt))
    want = program_rows(tree, p, ids, prompt, numerics_of(p, name))
    got = model.logits(tree, c, [{"ids": ids, "prompt": prompt,
                                  "cap_len": prompt}])[0]
    scale = got.abs().max()
    assert (got - want).abs().max() <= tol * scale


def test_capacity_drops_are_the_programs():
    """At one prompt where the prompt's experts overflow, the reference
    with the capacity the program used agrees and one without drops
    does not."""
    from repro_torch.models import moe as moe_mod

    c, p = smoke("deepseek_moe_16b")
    x = torch.randn(1, 40, c["hidden_size"],
                    generator=torch.Generator().manual_seed(3))
    tree = weights.make(c, 9, "cpu")
    lp = {k: v[0] for k, v in tree["segments"]["seg1"]["0"]["ffn"].items()}
    # route every row to the same experts: most copies overflow
    lp["router"] = torch.zeros_like(lp["router"])
    lp["router"][:, :3] = 1.0
    x = x.abs()
    want = moe_mod.moe_block(lp, x, p, numerics_of(p, "exact"))[0]
    cap = model.capacity(40, c)
    assert cap < 40
    assert torch.allclose(model.moe(lp, x[0], c, 40, 40), want, atol=1e-5)
    assert not torch.allclose(model.moe(lp, x[0], c, 0, 40), want,
                              atol=1e-3)


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_a_harness_run_is_correct(run_tiny, arch, loop):
    res = run_tiny(arch, loop)
    v = res["verdict"]
    assert v["correct"], v
    assert v["rows"] >= 10 and not v["short_or_bad"]
    assert res["metrics"]["output_tokens_per_s"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0


def test_reference_imports_nothing_of_the_program():
    from portbench import run as R

    assert R.reference_imports_program() == []
    here = pathlib.Path(model.__file__).parent
    for f in here.glob("*.py"):
        for n in ast.walk(ast.parse(f.read_text())):
            if isinstance(n, ast.ImportFrom):
                assert (n.module or "").split(".")[0] not in (
                    "repro_torch", "repro", "jax")


def test_route_witness_sets_the_programs_experts_beside_the_references():
    """``readings.py --routes``: the program's eager replay of a served
    stream records each MoE layer's experts at every row the check
    compares; at smoke size, where program and reference agree, no row
    takes other experts and every served token is the replay's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "portbench_readings", pathlib.Path(model.__file__).parents[1]
        / "readings.py")
    readings = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(readings)
    c, p = smoke("deepseek_moe_16b")
    tree = weights.make(c, 2_147_483_801, "cpu")
    g = torch.Generator().manual_seed(4)
    sample = []
    for n, cap in ((9, 16), (20, 20)):
        prompt = torch.randint(0, c["vocab_size"], (n,), generator=g)
        numerics = numerics_of(p, "interp-fused")
        out = []
        for _ in range(12):  # the program's own greedy tokens
            ids = torch.cat([prompt, torch.tensor(out, dtype=torch.long)])
            out.append(int(program_rows(tree, p, ids, n, numerics)[-1]
                           .argmax()))
        sample.append({"rid": n, "prompt": prompt.tolist(), "out": out,
                       "max_new": 12, "cap_len": cap})
    w = readings.route_flips(tree, c, sample, "cpu", pcfg=p)
    assert w["flipped"]["rows"] + w["unflipped"]["rows"] == 24
    assert w["flipped"]["rows"] == 0
    assert w["replay_agrees"] == [1.0, 1.0]
