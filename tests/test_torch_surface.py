"""The port's public surface against the reference's.

Every ``.py`` under ``src/repro/`` is read with ``ast``; its public
top-level names (defs, classes, assignments, ``__all__`` and the names a
package ``__init__`` re-exports) must exist in the twin module under
``src/repro_torch/``, apart from the names in ``HELD``, each of which
carries the one-line reason it has no twin. A name the reference gains
without a twin fails here, and so does a held name that the port has since
gained or the reference has dropped. The reference's own callers
(``benchmarks/``, its ``examples/``) must resolve every ``from repro.X
import Y`` in ``repro_torch.X``.

This file imports neither ``jax`` nor ``repro``: the reference is only
parsed.
"""
from __future__ import annotations

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

_PALLAS = "a Pallas entry; its CUDA kernel is"
_TILING = ("the Pallas kernels' TPU tiling; the CUDA kernels take any shape "
           "and the port copies no tile")

HELD: dict[str, dict[str, str]] = {
    "kernels/interp/kernel.py": {
        "BLOCK_ROWS": _TILING,
        "LANES": _TILING,
        "library_eval_2d": f"{_PALLAS} `library_eval_cuda` (PERF.md §6 row 1)",
        "library_walk_2d": f"{_PALLAS} `library_walk_cuda` (PERF.md §6 row 5)",
        "rom_eval_2d": f"{_PALLAS} `rom_eval_cuda` (PERF.md §6 row 6)",
        "interp_eval_2d": f"{_PALLAS} `interp_eval_cuda` (PERF.md §6 row 7)",
        "poly_tail": "the Pallas body's datapath tail; the port's is "
                     "`kernels.interp.ref.poly_tail` and `csrc/datapath.cuh`",
    },
    "kernels/rmsnorm/kernel.py": {
        "BLOCK_ROWS": _TILING,
        "fused_rmsnorm_lib": f"{_PALLAS} `rmsnorm_lib_cuda` (PERF.md §6 row 2)",
        "fused_rmsnorm": f"{_PALLAS} `rmsnorm_tab_cuda` (PERF.md §6 row 9)",
    },
    "kernels/softmax/kernel.py": {
        "BLOCK_ROWS": _TILING,
        "LOG2E": "a constant of the Pallas body; the port's is "
                 "`kernels.interp.ref.LOG2E`",
        "fused_softmax_lib": f"{_PALLAS} `softmax_lib_cuda` (PERF.md §6 row 4)",
        "fused_softmax": f"{_PALLAS} `softmax_tab_cuda` (PERF.md §6 row 8)",
    },
    "kernels/flashattn/kernel.py": {
        "BLOCK_Q": _TILING,
        "LOG2E": "a constant of the Pallas body; the port's is "
                 "`kernels.interp.ref.LOG2E`",
        "M_FLOOR": "a constant of the Pallas body; the plain version's is "
                   "`kernels.flashattn.ref.M_FLOOR`",
        "NEG": "a constant of the Pallas body; the plain version's is "
               "`kernels.flashattn.ref.NEG`",
        "flash_attention_lib": f"{_PALLAS} `flash_attn_lib_cuda` "
                               "(PERF.md §6 row 3)",
        "flash_attention": f"{_PALLAS} `flash_attn_tab_cuda` "
                           "(PERF.md §6 row 10)",
    },
    "kernels/dspace/kernel.py": {
        "TILE": _TILING,
        "envelopes_parity": f"{_PALLAS} `envelopes_parity_cuda`; the "
                            "wrapper of that name is `kernels.dspace.ops`'s "
                            "(PERF.md §6 row 13)",
        "envelopes_parity_batched": f"{_PALLAS} "
                                    "`envelopes_parity_batched_cuda`; the "
                                    "wrapper is `kernels.dspace.ops`'s "
                                    "(PERF.md §6 row 11)",
        "envelopes_parity_fleet": f"{_PALLAS} `envelopes_parity_fleet_cuda`; "
                                  "the wrapper is `kernels.dspace.ops`'s "
                                  "(PERF.md §6 row 12)",
    },
    "launch/mesh.py": {
        "ICI_BW": "a TPU interconnect constant; the port's one network "
                  "rate is `NET_BW` (an H100's link)",
        "DCN_BW": "a TPU data-centre network constant; the port's one "
                  "network rate is `NET_BW`",
    },
    "launch/sharding.py": {
        "constrain": "a GSPMD sharding hint; the port places shards "
                     "explicitly (`Mesh.tp_enter` / `tp_sum` / `tp_cat`)",
    },
    "launch/xprof.py": {
        "HloProfile": "a profile of XLA's HLO; no PyTorch meaning (the "
                      "port's is `OpProfile` from `profile_step`)",
        "analyze_hlo": "reads XLA's HLO; no PyTorch meaning (the port "
                       "traces torch ops: `profile_step`)",
        "breakdown": "parses HLO text; the port's is the method "
                     "`OpProfile.breakdown(top)`",
    },
    "models/layers.py": {
        "Params": "a JAX pytree alias; the port's trees are dicts of "
                  "tensors",
        "ShapeTree": "a JAX pytree alias; the port's shape trees are dicts",
    },
    "models/transformer.py": {
        "apply_block": "the `lax.scan` body over a stacked segment; the "
                       "port's layer is `apply_layer`, looped in `backbone`",
        "apply_segment": "a `lax.scan` over a stacked segment; the port "
                         "loops its layers in `backbone` (no stacked leaves)",
    },
    "serve/aot.py": {
        "compile_cached": "the reference's process-wide XLA executable "
                          "cache; the port's AOT programs are CUDA graphs "
                          "held per engine (a held difference)",
        "lookup": "reads the process-wide XLA executable cache; the port "
                  "holds its programs per engine",
        "clear_cache": "clears the process-wide XLA executable cache; the "
                       "port's go with their engine",
    },
    "serve/engine.py": {
        "make_engine_tick": "a jitted program of the reference's engine; "
                            "the port's tick is `ServeEngine._decode_chunk`, "
                            "captured as a CUDA graph on the engine's buffers",
        "make_engine_admit": "a jitted program of the reference's engine; "
                             "the port admits in `ServeEngine._admit_one`",
        "make_engine_admit_packed": "a jitted program of the reference's "
                                    "engine; the port's is "
                                    "`ServeEngine._admit_body`, graph-captured",
    },
}


def public_names(path: Path) -> set[str]:
    """The public top-level names of one reference module."""
    tree = ast.parse(path.read_text())
    package = path.name == "__init__.py"
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                out.update(e.id for e in elts if isinstance(e, ast.Name))
                if isinstance(t, ast.Name) and t.id == "__all__":
                    out.update(ast.literal_eval(node.value))
        elif package and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def twin(rel: str):
    """The port module twinned with reference module ``rel``."""
    parts = ["repro_torch", *rel[:-3].split("/")]
    if parts[-1] == "__init__":
        parts.pop()
    return importlib.import_module(".".join(parts))


MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_reference_names_exist_in_the_port(rel):
    mod = twin(rel)
    held = HELD.get(rel, {})
    missing = sorted(n for n in public_names(REF / rel)
                     if n not in held and not hasattr(mod, n))
    assert not missing, f"{rel}: no twin and no held reason for {missing}"


def test_held_names_are_still_held():
    """Each held name is still public in the reference and still absent
    from the port, and its reason is one line."""
    for rel, names in HELD.items():
        ref = public_names(REF / rel)
        mod = twin(rel)
        for name, reason in names.items():
            assert name in ref, f"{rel}: {name} left the reference"
            assert not hasattr(mod, name), f"{rel}: {name} has a twin now"
            assert reason and "\n" not in reason, (rel, name)


def _callers() -> list[str]:
    files = sorted(ROOT.glob("benchmarks/**/*.py"))
    files += sorted(p for p in ROOT.glob("examples/*.py")
                    if not p.name.startswith("torch_"))
    return [p.relative_to(ROOT).as_posix() for p in files]


def _imports(path: Path) -> list[tuple[str, str]]:
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == "repro"):
            out.extend((node.module, a.name) for a in node.names)
    return out


@pytest.mark.parametrize("caller", _callers())
def test_reference_callers_resolve_in_the_port(caller):
    """What the reference's benchmarks and examples import from ``repro``
    is importable from ``repro_torch`` under the same names."""
    unresolved = []
    for module, name in _imports(ROOT / caller):
        port = "repro_torch" + module[len("repro"):]
        mod = importlib.import_module(port)
        if hasattr(mod, name):
            continue
        try:
            importlib.import_module(f"{port}.{name}")
        except ModuleNotFoundError:
            unresolved.append(f"{port}.{name}")
    assert not unresolved, unresolved


_SURFACE = """
import sys
from repro_torch.serve import (ServeEngine, Request, BucketTable, HostPipeline,
                               load_requests)
from repro_torch.core import (get_spec, run_decision, regions_feasible,
                              TableDesign, generate_remez_table,
                              generate_table)
from repro_torch.configs import MoEConfig, MLAConfig, SSMConfig, EncoderConfig
from repro_torch.serve import engine, aot, journal, pipeline
from repro_torch.core import decision, designspace, table, remez, generate
from repro_torch.configs import base
assert ServeEngine is engine.ServeEngine and Request is engine.Request
assert BucketTable is aot.BucketTable and HostPipeline is pipeline.HostPipeline
assert load_requests is journal.load_requests
assert run_decision is decision.run_decision
assert regions_feasible is designspace.regions_feasible
assert TableDesign is table.TableDesign
assert generate_remez_table is remez.generate_remez_table
assert generate_table is generate.generate_table
assert (MoEConfig, MLAConfig, SSMConfig, EncoderConfig) == (
    base.MoEConfig, base.MLAConfig, base.SSMConfig, base.EncoderConfig)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert not bad, bad
print("ok")
"""


def test_package_surfaces_import_alone():
    """The package-level names, in a fresh interpreter, are the port's
    twins, and importing them pulls in neither jax nor the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _SURFACE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
