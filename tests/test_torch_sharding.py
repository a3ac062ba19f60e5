"""The port's sharding rule engine against the reference's, as data.

``repro_torch.launch.sharding`` must hand every parameter leaf of every
architecture the spec ``repro.launch.sharding`` hands it, on the
production meshes (``(16, 16)`` data x model, ``(2, 16, 16)`` pod x data x
model) under ``PARAM_RULES`` and on serve meshes under
``SERVE_PARAM_RULES``, at full width and on the smoke configs. The
reference side runs on a ``jax.sharding.AbstractMesh`` (no devices) over
``jax.eval_shape`` of its initializer; the port's on an abstract
``launch.mesh.Mesh`` over ``models.transformer.model_shapes`` (the leaf
names are the same in both trees, as ``convert.params_from_jax`` maps
them). Also the cache and batch specs, the mesh-spec parser, the pipeline
bubble, ``aot.mesh_key``, and ``shard_tree`` cutting every rank's shard so
that the shards put back together give the whole leaf.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as jcfg
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsh
from repro.launch.pipeline import bubble_fraction as j_bubble
from repro.models import transformer as jtf
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch.pipeline import bubble_fraction
from repro_torch.models import transformer as tf
from repro_torch.serve.aot import mesh_key
from repro_torch.util.tree import leaves_with_paths

torch.set_num_threads(1)

PRODUCTION = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SERVE = {"2x4": (2, 4), "1x8": (1, 8), "4x2": (4, 2)}


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str, smoke: bool):
    cfg = (jcfg.get_smoke_config if smoke else jcfg.get_config)(arch)
    return cfg, jax.eval_shape(lambda: jtf.init_params(jax.random.key(0),
                                                       cfg))


def _ref_specs(tree, mesh, rules) -> dict:
    specs = jsh.param_specs(tree, mesh, rules)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(s.spec) for path, s in flat}


def _port_specs(cfg, mesh, rules) -> dict:
    shapes = tf.model_shapes(cfg)
    specs = tsh.param_specs(shapes, mesh, rules)
    names = [n for n, _ in leaves_with_paths(shapes)]
    return dict(zip(names, tsh.spec_leaves(specs, len(names))))


def _pad(spec: tuple, n: int) -> tuple:
    """A PartitionSpec may leave trailing dimensions out."""
    return tuple(spec) + (None,) * (n - len(spec))


def _cases():
    for arch in ARCH_IDS:
        for smoke in (False, True):
            for name in PRODUCTION:
                yield pytest.param(arch, smoke, name,
                                   id=f"{arch}-{'smoke' if smoke else 'full'}"
                                      f"-{name}")
            for name in SERVE:
                yield pytest.param(arch, smoke, name,
                                   id=f"{arch}-{'smoke' if smoke else 'full'}"
                                      f"-serve{name}")


@pytest.mark.parametrize("arch,smoke,mesh_name", list(_cases()))
def test_param_specs_equal_the_reference(arch, smoke, mesh_name):
    jc, ref_tree = _ref_shapes(arch, smoke)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    if mesh_name in PRODUCTION:
        shape, axes = PRODUCTION[mesh_name]
        jm = AbstractMesh(shape, axes)
        tm = tmesh.make_production_mesh(multi_pod=len(shape) == 3)
        jr, tr = jsh.PARAM_RULES, tsh.PARAM_RULES
    else:
        data, tp = SERVE[mesh_name]
        jm = AbstractMesh((data, tp), ("data", "tp"))
        tm = tmesh.Mesh(("data", "tp"), (data, tp))
        jr, tr = jsh.SERVE_PARAM_RULES, tsh.SERVE_PARAM_RULES
    ref = _ref_specs(ref_tree, jm, jr)
    got = _port_specs(cfg, tm, tr)
    assert sorted(ref) == sorted(got)
    shapes = dict(leaves_with_paths(tf.model_shapes(cfg)))
    for name, spec in got.items():
        assert _pad(ref[name], len(shapes[name].shape)) == spec, name
    assert any(any(e is not None for e in s) for s in got.values())


def _field_specs(specs_by_path: dict, ndims: dict, kv_base: int) -> dict:
    """field -> the set of specs over the field's own trailing dims (the
    reference stacks a repeated segment's cache over its layers only, the
    port every layer's)."""
    base = {"k": kv_base, "v": kv_base, "pos": 2, "conv": 3, "ssm": 4}
    out: dict = {}
    for path, spec in specs_by_path.items():
        field = path.rsplit("/", 1)[-1].lstrip(".")
        n = base[field]
        out.setdefault(field, set()).add(_pad(spec, ndims[path])[-n:])
    return out


@pytest.mark.parametrize("arch", ["yi_6b", "minicpm3_4b", "mamba2_130m",
                                  "jamba_v0_1_52b", "deepseek_moe_16b"])
@pytest.mark.parametrize("mesh_name", ["16x16", "serve2x4", "serve1x8"])
def test_cache_specs_equal_the_reference(arch, mesh_name):
    jc = jcfg.get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    if mesh_name == "16x16":
        jm, tm = (AbstractMesh((16, 16), ("data", "model")),
                  tmesh.make_production_mesh())
    else:
        d, t = SERVE[mesh_name[5:]]
        jm, tm = (AbstractMesh((d, t), ("data", "tp")),
                  tmesh.Mesh(("data", "tp"), (d, t)))
    b, s = 16, 64
    rshapes = jtf.cache_shapes(jc, b, s)
    rspecs = jsh.cache_specs_sharding(rshapes, jc, jm)
    rflat, _ = jax.tree_util.tree_flatten_with_path(
        rspecs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    sflat, _ = jax.tree_util.tree_flatten_with_path(rshapes)
    rname = ["/".join(str(getattr(p, "key", getattr(p, "name", p)))
                      for p in path) for path, _ in rflat]
    ref = _field_specs(dict(zip(rname, (tuple(s.spec) for _, s in rflat))),
                       dict(zip(rname, (len(x.shape) for _, x in sflat))),
                       3 if cfg.mla is not None else 4)
    tshapes = tf.cache_shapes(cfg, b, s)
    named = leaves_with_paths(tshapes)
    tspecs = tsh.spec_leaves(tsh.cache_specs_sharding(tshapes, cfg, tm),
                             len(named))
    got = _field_specs(dict(zip((n for n, _ in named), tspecs)),
                       {n: len(x.shape) for n, x in named},
                       3 if cfg.mla is not None else 4)
    assert ref == got


@pytest.mark.parametrize("mesh_name", list(PRODUCTION) + ["serve2x4"])
def test_batch_specs_equal_the_reference(mesh_name):
    if mesh_name in PRODUCTION:
        shape, axes = PRODUCTION[mesh_name]
        jm = AbstractMesh(shape, axes)
        tm = tmesh.make_production_mesh(multi_pod=len(shape) == 3)
    else:
        jm, tm = (AbstractMesh((2, 4), ("data", "tp")),
                  tmesh.Mesh(("data", "tp"), (2, 4)))
    for b in (256, 8, 3):
        shapes = {"tokens": jax.ShapeDtypeStruct((b, 64), np.int32),
                  "mask": jax.ShapeDtypeStruct((b, 64), np.float32)}
        ref = {k: tuple(v.spec) for k, v in
               jsh.batch_specs(shapes, jm).items()}
        got = tsh.batch_specs({k: torch.empty(v.shape) for k, v in
                               shapes.items()}, tm)
        for k in ref:
            assert _pad(ref[k], 2) == got[k], (b, k)


@pytest.mark.parametrize("spec", ["2x4", "4", "1x1", "8X2", " 2x2 ", "",
                                  "0x2", "2x", "axb", "2x2x2", "-1x2"])
def test_parse_mesh_spec_matches_the_reference(spec):
    def call(fn):
        try:
            return fn(spec)
        except ValueError:
            return "ValueError"
    assert call(tmesh.parse_mesh_spec) == call(jmesh.parse_mesh_spec)


def test_bubble_fraction_and_mesh_key():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9
    assert bubble_fraction(4, 8) == j_bubble(4, 8)
    keys = [mesh_key(tmesh.Mesh(("data", "tp"), s,
                                ranks=np.arange(4).reshape(s)))
            for s in ((2, 2), (1, 4), (4, 1))]
    keys.append(mesh_key(tmesh.Mesh(("data", "tp"), (2, 2),
                                    ranks=np.array([[4, 5], [6, 7]]))))
    assert len({hash(k) for k in keys}) == len(keys) == len(set(keys))
    assert mesh_key(None) is None


def test_production_mesh_and_h100_constants():
    m = tmesh.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.ranks is None and m.coords is None
    with pytest.raises(ValueError):
        m.check_device(torch.device("cpu"))
    # H100 values, not the reference's TPU v5e ones
    assert tmesh.PEAK_FLOPS_BF16 != jmesh.PEAK_FLOPS_BF16
    assert tmesh.HBM_BW != jmesh.HBM_BW


@pytest.mark.parametrize("arch,data,tp", [("yi_6b", 2, 2), ("yi_6b", 1, 4),
                                          ("deepseek_moe_16b", 1, 2),
                                          ("qwen1_5_110b", 2, 2)])
def test_shard_tree_shards_put_back_give_the_leaf(arch, data, tp):
    """Every rank's shard of every leaf (``placement_specs``, SwiGLU halves
    cut half by half), put back in rank order, is the whole leaf; a
    ``[gate | up]`` shard holds matching gate and up columns."""
    cfg = get_smoke_config(arch)
    params = tf.init_params(cfg, 0, "cpu")
    glu = tsh.glu_leaves(params, cfg)
    abstract = tmesh.Mesh(("data", "tp"), (data, tp))
    specs = tsh.placement_specs(params, cfg, abstract,
                                tsh.SERVE_PARAM_RULES)
    shards = {}
    for d in range(data):
        for t in range(tp):
            m = tmesh.Mesh(("data", "tp"), (data, tp),
                           coords={"data": d, "tp": t})
            shards[d, t] = dict(leaves_with_paths(
                tsh.shard_tree(params, specs, m, glu)))
    named = leaves_with_paths(params)
    for (path, full), spec in zip(named, tsh.spec_leaves(specs)):
        parts = [shards[0, t][path] for t in range(tp)]
        split = [i for i, e in enumerate(spec) if "tp" in tsh.axes_of(e)]
        if not split:
            for d in range(data):
                assert torch.equal(shards[d, 0][path], full), path
            continue
        (dim,) = split
        if path in glu:
            halves = [torch.chunk(p, 2, dim) for p in parts]
            got = torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                            dim)
        else:
            got = torch.cat(parts, dim)
        assert torch.equal(got, full), path
    if cfg.n_kv_heads % tp:  # the replicated-KV placement
        wk = [s for p, s in zip((n for n, _ in named),
                                tsh.spec_leaves(specs))
              if p.endswith("mixer/wk")]
        assert all(all(e is None for e in s) for s in wk)


def test_placement_refuses_a_split_query_head():
    """Where ``tp`` does not divide the query heads the placement splits
    none: every leaf of the attention mixer is replicated over ``tp`` (it
    runs whole on every rank), while the MLP stays split."""
    cfg = get_smoke_config("yi_6b").replace(n_heads=6, n_kv_heads=2,
                                            head_dim=16)
    shapes = tf.model_shapes(cfg)
    mesh = tmesh.Mesh(("data", "tp"), (1, 4))
    assert tsh.whole_mixer(cfg, mesh, "attn")
    specs = tsh.placement_specs(shapes, cfg, mesh, tsh.SERVE_PARAM_RULES)
    named = [p for p, _ in leaves_with_paths(shapes)]
    leaves = dict(zip(named, tsh.spec_leaves(specs, len(named))))
    mixer = [p for p in named if "/mixer/" in p]
    assert mixer and all("tp" not in tsh.axes_of(e)
                         for p in mixer for e in leaves[p])
    assert any("tp" in tsh.axes_of(e)
               for p in named if "/ffn/" in p for e in leaves[p])
