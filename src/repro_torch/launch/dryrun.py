"""Multi-pod dry run (twin of ``repro/launch/dryrun.py``): trace every
(architecture x input shape x mesh) cell as one rank of the production
mesh and write its memory and its per-rank op profile to JSON.

The reference lowers and compiles each cell on 512 placeholder devices
and reads XLA's memory and cost analyses and the partitioned HLO. The port
has no compiler in between: a cell is one rank's step (the train step,
the prefill or one decode step, as ``launch.train`` / ``serve.engine``
run it) traced on fake tensors (``launch.xprof.profile_step``) over a
traced production mesh (``launch.mesh.make_production_mesh(trace=True)``:
``(16, 16)`` ``data x model`` or ``(2, 16, 16)`` ``pod x data x model``;
this rank at coordinate 0, every collective recorded and shaped). The
port is SPMD, so that one rank's op stream is the per-rank program. No
device is used and nothing is allocated.

Each rank holds what the port places there: a train cell's state by
``train.step.train_specs`` (Megatron over ``model``, ZeRO-3 over ``pod x
data``), a serving cell's weights by ``SERVE_PARAM_RULES`` (Megatron over
``model``, replicated over the data axes, as the serving engine places
them; the reference's dry run shards them over ``fsdp`` too) and its cache
by ``cache_placement_specs``; the batch is this rank's rows. The configs'
own numerics (``exact`` for all ten) are traced.

A record keeps the reference's keys: ``lower_s`` is the trace time,
``compile_s``, ``generated_code_bytes`` and ``xla_cost_*`` are null,
``memory.argument_bytes`` is this rank's shards of state, inputs and
caches, ``output_bytes`` what the step returns, ``temp_bytes`` the
profile's ``peak_live_bytes``, and ``profile`` the profile's
``to_dict()``. Every file written carries ``"package": "repro_torch"``
(:data:`PACKAGE`), and the default directory is the port's own,
``artifacts/dryrun_torch``: the reference's records (in
``artifacts/dryrun``, its HBM bytes counted another way) never enter the
port's roofline (``launch.roofline.load_records`` reads stamped records
only).

Usage:
    python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--out artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeConfig, cell_is_runnable,
                                      get_config)
from repro_torch.launch import sharding as shlib
from repro_torch.launch.inputs import batch_shapes, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.xprof import profile_step, tensor_bytes
from repro_torch.models import transformer as tf
from repro_torch.models.layers import spec
from repro_torch.train.step import (StepConfig, TrainState, make_train_step,
                                    train_specs, train_state_shapes)
from repro_torch.util.tree import leaves_with_paths, unflatten_like

DEFAULT_OUT = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
               / "dryrun_torch")
# the stamp of every record this package writes
PACKAGE = "repro_torch"


def _local(shapes, specs, mesh):
    """The Spec tree of this rank's shards of ``shapes`` by ``specs``."""
    named = leaves_with_paths(shapes)
    out = [spec(shlib.local_shape(sp.shape, e, mesh), sp.dtype)
           for (_, sp), e in zip(named, shlib.spec_leaves(specs, len(named)))]
    return unflatten_like(shapes, out)


def _rows(tree, mesh):
    """This rank's rows of a batch-major Spec tree (``batch_specs``)."""
    return _local(tree, shlib.batch_specs(tree, mesh), mesh)


def _serve_params(cfg: ModelConfig, mesh):
    shapes = tf.model_shapes(cfg)
    return _local(shapes, shlib.placement_specs(
        shapes, cfg, mesh, shlib.SERVE_PARAM_RULES), mesh)


def _train_cell(cfg, shape: ShapeConfig, mesh, step_cfg: StepConfig):
    full = train_state_shapes(cfg, step_cfg)
    specs = train_specs(cfg, mesh)

    def cut(tree):
        return None if tree is None else _local(tree, specs, mesh)
    state = TrainState(cut(full.params),
                       type(full.opt)(full.opt.step, cut(full.opt.master),
                                      cut(full.opt.mu), cut(full.opt.nu)),
                       cut(full.residual))
    batch = _rows(batch_shapes(cfg, shape.global_batch, shape.seq_len), mesh)
    step = make_train_step(cfg, step_cfg, mesh=mesh)
    return (lambda st, b: step(st, b, 0)), (state, batch)


def _prefill_cell(cfg, shape: ShapeConfig, mesh):
    from repro_torch.serve.engine import make_prefill

    specs = _rows(input_specs(cfg, shape), mesh)
    extras = {k: specs[k] for k in ("frontend_emb", "enc_frames")
              if k in specs}
    pf = make_prefill(cfg, shape.seq_len, mesh=mesh)

    def run(params, tokens, extras):
        return pf(params, tokens, **extras)
    return run, (_serve_params(cfg, mesh), specs["tokens"], extras)


def _decode_cell(cfg, shape: ShapeConfig, mesh):
    from repro_torch.serve.engine import make_serve_step

    specs = input_specs(cfg, shape)
    caches = _local(specs["caches"], shlib.cache_placement_specs(
        specs["caches"], cfg, mesh), mesh)
    token = _rows({"t": specs["token"]}, mesh)["t"]
    args = [_serve_params(cfg, mesh), token, specs["pos"], caches]
    if "cross" in specs:
        args.append(_rows({"c": specs["cross"]}, mesh)["c"])
    return make_serve_step(cfg, mesh=mesh), tuple(args)


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               step_cfg: StepConfig | None = None,
               cfg: ModelConfig | None = None):
    """The cell's step and its abstract (Spec) arguments on the traced
    production mesh: ``(fn, args, mesh)``, ready for ``profile_step``
    (the reference lowers here; the port traces in :func:`run_cell`)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, trace=True)
    step_cfg = step_cfg or StepConfig(microbatches=1, compress_pods=multi_pod)
    if shape.kind == "train":
        fn, args = _train_cell(cfg, shape, mesh, step_cfg)
    elif shape.kind == "prefill":
        fn, args = _prefill_cell(cfg, shape, mesh)
    else:
        fn, args = _decode_cell(cfg, shape, mesh)
    return fn, args, mesh


def _write(out_dir, name: str, rec: dict) -> None:
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{name}.json").write_text(
            json.dumps({**rec, "package": PACKAGE}, indent=1, default=str))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: pathlib.Path | None = None, save_ops: bool = False,
             cfg: ModelConfig | None = None, tag: str = "",
             step_cfg: StepConfig | None = None) -> dict:
    shape = SHAPES[shape_name]
    the_cfg = cfg or get_config(arch)
    ok, why = cell_is_runnable(the_cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"{arch}_{shape_name}_{mesh_name}{tag}"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(out_dir, name, rec)
        return rec
    t0 = time.perf_counter()
    try:
        fn, args, _ = lower_cell(arch, shape_name, multi_pod, step_cfg,
                                 the_cfg)
        prof, out = profile_step(fn, *args)
        t_trace = time.perf_counter() - t0
        rec.update(
            status="ok",
            lower_s=round(t_trace, 2),
            compile_s=None,
            memory={
                "argument_bytes": tensor_bytes(args),
                "output_bytes": tensor_bytes(out),
                "temp_bytes": prof.peak_live_bytes,
                "generated_code_bytes": None,
            },
            xla_cost_flops=None,
            xla_cost_bytes=None,
            profile=prof.to_dict(),
        )
        if save_ops and out_dir is not None:
            _write(out_dir, f"{name}.ops", {"ops": prof.breakdown(200)})
    except Exception as e:  # a failure here is a bug in the placement
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _write(out_dir, name, rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-ops", action="store_true",
                    help="also write each cell's op breakdown "
                         "(<cell>.ops.json)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    cells = ([(a, s, m) for a in ARCH_IDS for s in SHAPES
              for m in (False, True)]
             if args.all else [(args.arch, args.shape, args.multi_pod)])
    n_ok = n_skip = n_err = 0
    t0 = time.perf_counter()
    for arch, shape, multi in cells:
        rec = run_cell(arch, shape, multi, out, save_ops=args.save_ops,
                       tag=args.tag)
        n_ok += rec["status"] == "ok"
        n_skip += rec["status"] == "skipped"
        n_err += rec["status"] == "error"
        msg = rec.get("error", "") or f"trace {rec.get('lower_s', '-')}s"
        print(f"[{rec['status']:>7}] {arch:18s} {shape:12s} "
              f"{rec['mesh']:10s} {msg}", flush=True)
    print(f"wall {time.perf_counter() - t0:.1f}s")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
