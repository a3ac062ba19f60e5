"""Logical-axis sharding: the rule engine that maps named tensor axes to
mesh axes (twin of ``repro/launch/sharding.py``).

The rule tables, ``_resolve`` and the spec builders are the reference's,
verbatim: a logical name takes the first candidate mesh axis (or axes) that
exists on the mesh, is not taken by another dimension of the same tensor,
and divides the dimension; else the dimension is replicated. A spec is a
tuple, one entry per dimension: ``None``, an axis name, or a tuple of axis
names (the twin of ``jax.sharding.PartitionSpec``).

The reference hands these specs to GSPMD, which inserts the collectives.
The port has no GSPMD: :func:`shard_tree` slices each full leaf into this
rank's shard by its spec, :func:`gather_tree` is the inverse (all-gathers
over the axes a leaf is split on), and the models issue the Megatron
collectives themselves (``launch.mesh.Mesh.tp_*``). Where the placement
differs from the specs, :func:`placement_specs`, :func:`split_leaves` and
:func:`cache_placement_specs` say so:

* a SwiGLU ``wi`` (``[gate | up]`` along its last axis) is split half by
  half (:func:`glu_leaves`), so each rank holds matching gate and up
  columns;
* where ``tp`` does not divide ``n_kv_heads`` but divides
  ``n_kv_heads * head_dim``, the spec would split one KV head: ``wk`` /
  ``wv`` are replicated over ``tp`` instead and every rank computes all
  KV heads (the reference's cache spec already replicates the KV pool
  there: ``kv_seq`` has no ``tp`` candidate);
* a Mamba2 mixer split by heads (:func:`ssm_head_parallel`) cuts its
  ``in_proj`` segment by segment (``[z | x | B | C | dt]``: each rank
  holds its heads' z, x and dt and a ``1 / tp`` slice of B and C) and its
  ``conv_w`` / ``conv_b`` likewise (``[x | B | C]``);
* a mixer whose heads ``tp`` does not divide (:func:`whole_mixer`: GQA,
  MLA or Mamba2) is replicated over ``tp`` and runs whole on every rank,
  with its cache;
* the decode cache's sequence axis is never split (``kv_seq``'s
  ``model`` candidate is the reference's sequence parallelism, which the
  port does not run).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.util.tree import leaves_with_paths, unflatten_like

_state = threading.local()

# logical axis -> ordered mesh-axis candidates (first divisible one wins).
# Training meshes name their TP axis "model"; the serving mesh
# (launch.mesh.make_serve_mesh) names it "tp" — both appear as candidates so
# the same model annotations resolve on either without a separate rule set.
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    "batch": (("pod", "data"), ("data",)),
    "seq": (("model",),),  # sequence parallelism (long-context fallback)
    "heads": (("model",), ("tp",)),
    "kv_heads": (("model",), ("tp",)),
    "embed": (),  # activations replicated along d_model by default
    "mlp": (("model",), ("tp",)),
    "vocab": (("model",), ("tp",)),
    "expert": (("model",), ("tp",)),
    "kv_seq": (("model",),),  # decode KV cache sequence axis
}


class NamedSharding(NamedTuple):
    """A spec on a mesh (the twin of ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: tuple


@contextlib.contextmanager
def axis_rules(mesh, rules: dict | None = None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _state.ctx = prev


def active_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def _resolve(name: Optional[str], size: int, mesh, rules: dict,
             taken: set[str]) -> Optional[tuple[str, ...]]:
    if name is None:
        return None
    for cand in rules.get(name, ()):
        if any(ax in taken or ax not in mesh.shape for ax in cand):
            continue
        total = 1
        for ax in cand:
            total *= mesh.shape[ax]
        if size % total == 0 and size > 0:
            return cand
    return None


def logical_spec(names: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: dict) -> tuple:
    taken: set[str] = set()
    out = []
    for name, size in zip(names, shape):
        axes = _resolve(name, int(size), mesh, rules, taken)
        if axes is None:
            out.append(None)
        else:
            taken.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def named_sharding(names: Sequence[Optional[str]], shape: Sequence[int],
                   mesh, rules: dict | None = None) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(names, shape, mesh,
                                            rules or DEFAULT_RULES))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ---------------------------------------------------------------------------
# parameter / state sharding (name-based Megatron TP x FSDP rules)
# ---------------------------------------------------------------------------

# logical parameter axes; resolution falls back left-to-right per candidate
PARAM_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    "tp": (("model",), ("tp",)),         # Megatron column/row axis
    "fsdp": (("pod", "data"), ("data",)),  # ZeRO-3 shard of the other big axis
    "expert": (("model",), ("tp",)),     # expert parallelism
    "vocab": (("model",), ("tp",)),
}

# Serving-tier parameter rules: weights tensor-parallel over the serve
# mesh's "tp" axis, *replicated* over "data" (batch slots are the
# data-parallel unit when serving, not parameters).
SERVE_PARAM_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    "tp": (("tp",), ("model",)),
    "fsdp": (),
    "expert": (("tp",), ("model",)),
    "vocab": (("tp",), ("model",)),
}

# The port's training placement is the reference's: Megatron over "model"
# and ZeRO-3 over "fsdp" (pod x data, or data) for the parameters, the
# AdamW master and moments and the compression residual.
TRAIN_PARAM_RULES: dict[str, tuple[tuple[str, ...], ...]] = PARAM_RULES

# leaf-name suffix -> logical axes for the *trailing* dims (stacked layer
# dims are padded with None on the left automatically)
_COL = ("fsdp", "tp")   # (d_in, d_out) column-parallel: shard d_out
_ROW = ("tp", "fsdp")   # (d_in, d_out) row-parallel: shard d_in
_PARAM_AXES: tuple[tuple[str, tuple], ...] = (
    ("embed/tok", ("vocab", "fsdp")),
    ("embed/head", ("fsdp", "vocab")),
    ("projector/w1", _COL), ("projector/w2", _ROW),
    ("mixer/wq", _COL), ("mixer/wk", _COL), ("mixer/wv", _COL),
    ("mixer/wo", _ROW),
    ("cross/wq", _COL), ("cross/wk", _COL), ("cross/wv", _COL), ("cross/wo", _ROW),
    ("wq_a", _COL), ("wq_b", _COL), ("wkv_a", _COL), ("wkv_b", _COL),
    ("ffn/wi", _COL), ("ffn/wo", _ROW),
    ("shared_wi", _COL), ("shared_wo", _ROW),
    ("router", ("fsdp", None)),
    ("in_proj", _COL), ("out_proj", _ROW),
    ("conv_w", (None, "tp")), ("conv_b", ("tp",)),
    ("pos", (None, "fsdp")),
)
# MoE expert tensors: intra-expert Megatron col/row — d_expert on the TP
# axis, d_model on FSDP, experts replicated, the router replicated.
_MOE_TP = {"ffn/wi": (None, "fsdp", "tp"), "ffn/wo": (None, "tp", "fsdp")}


def param_logical_axes(name: str, ndim: int, shape: tuple = (),
                       mesh=None) -> tuple:
    for suffix, axes in _PARAM_AXES:
        if suffix in name:
            if suffix in _MOE_TP and ndim >= 3:
                cand = _MOE_TP[suffix]
                if ndim in (3, 4):  # maybe scan-stacked
                    axes3 = cand if ndim == 3 else (None, *cand)
                    return axes3
            pad = ndim - len(axes)
            if pad < 0:
                return (None,) * ndim
            return (None,) * pad + tuple(axes)
    return (None,) * ndim  # norms, biases, scalars: replicated


def _shape(leaf) -> tuple:
    return tuple(int(s) for s in leaf.shape)


def param_specs(shapes, mesh, rules: dict | None = None):
    """A tree of leaves with a ``shape`` (tensors or ``Spec``) -> the same
    tree of specs."""
    rules = rules or PARAM_RULES
    named = leaves_with_paths(shapes)
    out = []
    for name, leaf in named:
        shape = _shape(leaf)
        names = param_logical_axes(name, len(shape), shape, mesh)
        out.append(logical_spec(names, shape, mesh, rules))
    return unflatten_like(shapes, out)


def batch_specs(batch_shapes, mesh, rules: dict | None = None):
    """Input batch: leading axis is the global batch -> DP axes."""
    r = dict(DEFAULT_RULES)
    r.update(rules or {})
    out = []
    for _, leaf in leaves_with_paths(batch_shapes):
        shape = _shape(leaf)
        names = ("batch",) + (None,) * (len(shape) - 1)
        out.append(logical_spec(names, shape, mesh, r))
    return unflatten_like(batch_shapes, out)


def cache_specs_sharding(cache_shapes, cfg, mesh):
    """KV caches: batch->data; kv-heads->model if divisible, else the cache
    sequence axis (sequence parallelism for long-context decode).

    Field layouts (a leading stacked layer dim may be prepended):
      GQA:  k,v (B, KV, S, D)   pos (B, S)
      MLA:  k (B, S, lora)  v (B, S, rope)  pos (B, S)
      SSM:  conv (B, K, C)  ssm (B, H, P, N)
    """
    kv_base = 3 if cfg.mla is not None else 4
    rules = dict(DEFAULT_RULES)
    rules["tp"] = (("model",), ("tp",))
    out = []
    for path, leaf in leaves_with_paths(cache_shapes):
        field = path.rsplit("/", 1)[-1]
        shape = _shape(leaf)
        base = {"k": kv_base, "v": kv_base, "pos": 2, "conv": 3,
                "ssm": 4}[field]
        if field in ("k", "v"):
            names = (("batch", "kv_heads", "kv_seq", None) if kv_base == 4
                     else ("batch", "kv_seq", None))
        elif field == "pos":
            names = ("batch", "kv_seq")
        elif field == "conv":
            names = ("batch", None, "tp")
        else:  # ssm state
            names = ("batch", "heads", None, None)
        if len(shape) == base + 1:
            names = (None, *names)
        out.append(logical_spec(names, shape, mesh, rules))
    return unflatten_like(cache_shapes, out)


# ---------------------------------------------------------------------------
# the port's placement: explicit local shards
# ---------------------------------------------------------------------------

def axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_index(entry, mesh) -> tuple[int, int]:
    """(this rank's chunk, the chunk count) of a dimension whose spec entry
    is ``entry``: row-major over its axes."""
    i, n = 0, 1
    for ax in axes_of(entry):
        i = i * mesh.shape[ax] + mesh.index(ax)
        n *= mesh.shape[ax]
    return i, n


def local_shape(shape, spec, mesh) -> tuple:
    out = []
    for size, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = math.prod(mesh.shape[ax] for ax in axes_of(entry))
        out.append(int(size) // n)
    return tuple(out)


def glu_leaves(tree, cfg) -> frozenset:
    """The paths of the leaves whose last axis is ``[gate | up]``: every
    MoE ``wi`` and ``shared_wi`` (SwiGLU experts), and a dense ``ffn/wi``
    under ``act="silu"``."""
    paths = {p for p, _ in leaves_with_paths(tree)}
    out = set()
    for path in paths:
        parent, _, leaf = path.rpartition("/")
        if leaf == "shared_wi" or (
                leaf == "wi" and parent.endswith("ffn")
                and (f"{parent}/router" in paths or cfg.act == "silu")):
            out.add(path)
    return frozenset(out)


def _segments(split, path: str, size: int):
    """The full sizes of the last-axis segments of the leaf at ``path``
    (``split``: :func:`glu_leaves`' set, two halves each, or
    :func:`split_leaves`' dict), or None."""
    if isinstance(split, dict):
        return split.get(path)
    return (size // 2, size - size // 2) if path in split else None


def _slice(t: torch.Tensor, dim: int, i: int, n: int,
           segs=None) -> torch.Tensor:
    size = t.shape[dim]
    if n == 1:
        return t
    if segs is not None and dim == t.dim() - 1:
        if sum(segs) != size or any(g % n for g in segs):
            raise ValueError(f"segments {segs} of an axis of {size} do "
                             f"not split into {n} matching chunks")
        parts, off = [], 0
        for g in segs:
            w = g // n
            parts.append(t.narrow(dim, off + i * w, w))
            off += g
        return torch.cat(parts, dim)
    if size % n:
        raise ValueError(f"axis of {size} does not split into {n} shards")
    return t.narrow(dim, i * (size // n), size // n)


def _unsegment(g: torch.Tensor, widths: list, n: int,
               dim: int) -> torch.Tensor:
    """``n`` gathered blocks of ``[seg 0 | seg 1 | ...]`` (local widths
    ``widths``) along ``dim`` -> each segment's blocks side by side."""
    block = sum(widths)
    parts = []
    off = 0
    for w in widths:
        parts += [g.narrow(dim, j * block + off, w) for j in range(n)]
        off += w
    return torch.cat(parts, dim)


def shard_tree(full_tree, specs, mesh, glu=frozenset()):
    """This rank's shard of every leaf of ``full_tree`` by its spec in
    ``specs`` (a tree of the same structure): contiguous chunks along each
    split dimension; along the last axis of the paths in ``glu`` (a set:
    ``[gate | up]`` halves; a dict: :func:`split_leaves`' segments) each
    segment chunked separately. Plain tensor ops; a leaf split no way (a
    1-way axis, or none) is handed back as it is, every other shard is a
    new contiguous tensor."""
    named = leaves_with_paths(full_tree)
    specs_ = spec_leaves(specs, len(named))
    out = []
    for (path, leaf), spec in zip(named, specs_):
        t = leaf
        segs = _segments(glu, path, leaf.shape[-1]) if leaf.dim() else None
        for dim, entry in enumerate(spec):
            if axes_of(entry):
                i, n = shard_index(entry, mesh)
                t = _slice(t, dim, i, n, segs)
        if t is not leaf:  # a proper shard owns its memory
            t = t.clone(memory_format=torch.contiguous_format)
        out.append(t)
    return unflatten_like(full_tree, out)


def gather_tree(local_tree, specs, mesh, glu=frozenset()):
    """The inverse of :func:`shard_tree`: every leaf all-gathered along
    the dimensions its spec splits (the inner axis of a multi-axis entry
    first), ``[gate | up]`` halves for the paths in ``glu``."""
    named = leaves_with_paths(local_tree)
    specs_ = spec_leaves(specs, len(named))
    out = []
    for (path, t), spec in zip(named, specs_):
        for dim, entry in enumerate(spec):
            axes = axes_of(entry)
            segs = (_segments(glu, path, 0) if dim == t.dim() - 1 and axes
                    else None)
            if not isinstance(glu, dict) and segs is not None:
                segs = (t.shape[dim] * math.prod(
                    mesh.shape[ax] for ax in axes) // 2,) * 2
            n_left = math.prod(mesh.shape[ax] for ax in axes)
            for ax in reversed(axes):
                g = mesh.all_gather(t, ax, dim)
                if segs is not None:
                    g = _unsegment(g, [w // n_left for w in segs],
                                   mesh.shape[ax], dim)
                    n_left //= mesh.shape[ax]
                t = g
        out.append(t)
    return unflatten_like(local_tree, out)


def spec_leaves(specs, n: int | None = None) -> list:
    """The spec tuples of a spec tree, in flattening order (a spec is a
    tuple: the tree helpers would walk into it); ``n`` the leaf count to
    check."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(getattr(x, f))
        elif isinstance(x, list):
            for v in x:
                walk(v)
        elif x is not None:
            out.append(tuple(x))

    walk(specs)
    if n is not None and len(out) != n:
        raise ValueError(f"{len(out)} specs for {n} leaves")
    return out


def ssm_head_parallel(cfg, tp: int) -> bool:
    """Whether the Mamba2 mixer of ``cfg`` splits by heads over ``tp``
    ranks: ``tp`` divides its heads and ``n_groups * d_state`` (each rank
    a slice of B and C), with one group."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    return (s.n_groups == 1 and heads % tp == 0
            and (s.n_groups * s.d_state) % tp == 0)


def whole_mixer(cfg, mesh, mixer: str) -> bool:
    """Whether a ``mixer`` ("attn", "mla", "ssm", "cross") of ``cfg`` runs
    whole on every rank of ``mesh``'s ``tp`` (replicated weights, no
    collective) because ``tp`` does not divide its heads."""
    tp = mesh.tp if mesh is not None else 1
    if tp == 1:
        return False
    if mixer == "ssm":
        return cfg.ssm is not None and not ssm_head_parallel(cfg, tp)
    return cfg.n_heads % tp != 0


def _mixer_of(path: str, cfg) -> str | None:
    """The mixer kind a leaf at ``path`` belongs to (None: not a mixer's
    leaf)."""
    if "/cross/" in path or path.startswith("cross/"):
        return "cross"
    if "mixer/" not in path:
        return None
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias",
                "d_skip", "out_proj") or "mixer/norm/" in path:
        return "ssm"
    return "mla" if cfg.mla is not None else "attn"


def placement_specs(shapes, cfg, mesh, rules: dict | None = None):
    """:func:`param_specs` as the port places them: ``wk`` / ``wv``
    replicated over ``tp`` where it would split a KV head, and every leaf
    of a mixer :func:`whole_mixer` runs whole replicated over ``tp``
    (module docstring). Biases follow the specs (replicated); the models read
    their own columns of them."""
    specs = param_specs(shapes, mesh, rules)
    tp_ax = mesh.tp_axis
    if tp_ax is None:
        return specs
    tp = mesh.shape[tp_ax]
    named = leaves_with_paths(shapes)
    specs_ = spec_leaves(specs, len(named))
    whole = {m: whole_mixer(cfg, mesh, m)
             for m in ("attn", "mla", "ssm", "cross")}
    out = []
    for (path, _), spec in zip(named, specs_):
        split = any(tp_ax in axes_of(e) for e in spec)
        mixer = _mixer_of(path, cfg)

        def drop(sp):
            return tuple(None if tp_ax in axes_of(e) else e for e in sp)
        if split and mixer is not None and whole[mixer]:
            spec = drop(spec)
        elif split and tp > 1 and cfg.n_kv_heads % tp and path.endswith(
                ("mixer/wk", "mixer/wv", "cross/wk", "cross/wv")):
            spec = drop(spec)
        out.append(spec)
    return unflatten_like(shapes, out)


def split_leaves(tree, cfg, mesh) -> dict:
    """Path -> the full sizes of the last-axis segments each segment of
    which is chunked on its own (:func:`shard_tree`): the ``[gate | up]``
    halves of :func:`glu_leaves` and, where the Mamba2 mixer splits by
    heads (:func:`ssm_head_parallel`), ``in_proj``'s ``[z | x | B | C |
    dt]`` and ``conv_w`` / ``conv_b``'s ``[x | B | C]``."""
    leaves = dict(leaves_with_paths(tree))
    out = {}
    for path in glu_leaves(tree, cfg):
        n = leaves[path].shape[-1]
        out[path] = (n // 2, n // 2)
    tp = mesh.tp if mesh is not None else 1
    if cfg.ssm is not None and tp > 1 and ssm_head_parallel(cfg, tp):
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        gn = s.n_groups * s.d_state
        heads = d_inner // s.head_dim
        for path in leaves:
            if path.endswith("mixer/in_proj"):
                out[path] = (d_inner, d_inner, gn, gn, heads)
            elif path.endswith(("mixer/conv_w", "mixer/conv_b")):
                out[path] = (d_inner, gn, gn)
    return out


def cache_placement_specs(cache_shapes, cfg, mesh):
    """:func:`cache_specs_sharding` as the port places the cache: the
    sequence axis never split, and the SSM state and conv window
    replicated over ``tp`` where the Mamba2 mixer runs whole
    (:func:`whole_mixer`)."""
    tp_ax = mesh.tp_axis
    specs = cache_specs_sharding(cache_shapes, cfg, mesh)
    if tp_ax is None:
        return specs
    whole_ssm = cfg.ssm is not None and whole_mixer(cfg, mesh, "ssm")
    kv_base = 3 if cfg.mla is not None else 4
    out = []
    for (path, leaf), spec in zip(leaves_with_paths(cache_shapes),
                                  spec_leaves(specs)):
        field = path.rsplit("/", 1)[-1]
        lead = len(leaf.shape) - {"k": kv_base, "v": kv_base, "pos": 2,
                                  "conv": 3, "ssm": 4}[field]
        spec = list(spec)
        seq = {"k": 2 if kv_base == 4 else 1, "v": 2 if kv_base == 4 else 1,
               "pos": 1}.get(field)
        if seq is not None and tp_ax in axes_of(spec[lead + seq]):
            spec[lead + seq] = None
        if field in ("conv", "ssm") and whole_ssm:
            spec = [None if tp_ax in axes_of(e) else e for e in spec]
        out.append(tuple(spec))
    return unflatten_like(cache_shapes, out)
