"""``portbench/work.py`` against the port's own op tracer
(``repro_torch.launch.xprof``) at smoke size: the FLOPs of a prefill and
of a decode row, and the bytes of a ``flash_attn_lib`` launch."""
from __future__ import annotations

import ast
import pathlib

import pytest
import torch

from portbench import work
from portbench.tests.conftest import smoke


def traced(arch: str, fn: str, *shape):
    from repro_torch.api.library import InterpLibrary
    from repro_torch.launch.xprof import profile_step
    from repro_torch.models import transformer as tf
    from repro_torch.numerics.ops import get_numerics

    c, p = smoke(arch)
    p = p.replace(numerics="interp-fused")
    num = get_numerics(p, InterpLibrary.default_library("cpu"), fused=True)
    if fn == "prefill":
        (n,) = shape
        prof, _ = profile_step(tf.prefill, tf.param_shapes(p),
                               torch.zeros(1, n, dtype=torch.long), p, num,
                               64)
    else:
        b, rows = shape
        prof, _ = profile_step(
            tf.decode_step, tf.param_shapes(p),
            torch.zeros(b, 1, dtype=torch.long),
            torch.full((b,), rows - 1, dtype=torch.int32),
            tf.cache_shapes(p, b, rows), p, num)
    return c, prof


def experts(prof) -> float:
    """The tracer's FLOPs of the expert products, which run every
    expert's capacity rows (model FLOPs count the chosen experts)."""
    return sum(r["flops"] for (op, where), r in prof.ops.items()
               if op == "bmm" and "moe" in where)


def chosen_experts(c: dict, rows: int) -> float:
    if "n_routed_experts" not in c:
        return 0.0
    d, de = c["hidden_size"], c["moe_intermediate_size"]
    per = 2 * 3 * d * de * c["num_experts_per_tok"]
    return per * rows * (c["num_hidden_layers"] - c["first_k_dense_replace"])


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
@pytest.mark.parametrize("n", [1, 24, 37])
def test_prefill_flops_equal_the_tracer(arch, n):
    c, prof = traced(arch, "prefill", n)
    assert work.prefill_flops(c, n) == (prof.flops - experts(prof)
                                        + chosen_experts(c, n))


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
@pytest.mark.parametrize("b,rows", [(1, 17), (3, 40)])
def test_decode_flops_equal_the_tracer(arch, b, rows):
    # every cache row live: the tracer counts every row of a decode
    c, prof = traced(arch, "decode", b, rows)
    assert b * work.decode_flops(c, rows - 1) == (
        prof.flops - experts(prof) + chosen_experts(c, b))


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_flash_launch_equals_the_tracer(arch):
    c, prof = traced(arch, "prefill", 24)
    row = prof.ops[("flash_attn_lib", "kernel")]
    n = c["num_hidden_layers"]
    f, b = work.flash_launch(c, [(24, 0)], elem=4)  # float32 at smoke size
    assert (f * n, b * n) == (row["flops"], row["bytes"])
    c, prof = traced(arch, "decode", 3, 40)
    row = prof.ops[("flash_attn_lib", "kernel")]
    f, b = work.flash_launch(c, [(1, 39)] * 3, elem=4)
    assert (f * n, b * n) == (row["flops"], row["bytes"])


def test_work_imports_nothing_of_the_program():
    tree = ast.parse((pathlib.Path(work.__file__)).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in (
        "repro_torch", "repro", "jax")]
