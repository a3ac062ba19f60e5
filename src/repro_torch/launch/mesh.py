"""Device meshes over ``torch.distributed`` (twin of ``repro/launch/mesh.py``).

The reference's meshes are ``jax.sharding.Mesh`` objects over the devices
one controller sees. The port runs one process per rank (``torchrun``, or a
test's own launcher), so a :class:`Mesh` is this rank's view of a grid of
global ranks: the axis names and sizes, this rank's coordinates, and one
``torch.distributed`` subgroup per axis (plus one over the whole mesh).
Every rank of the world must build the same meshes in the same order:
``new_group`` is a collective call.

Axes, as the reference's:

* ``pod``   — outer data parallelism across pods.
* ``data``  — data parallelism: batch rows in training, slots in serving.
* ``model`` — tensor parallelism in training (Megatron column / row).
* ``tp``    — tensor parallelism in serving (``make_serve_mesh``).
* ``stage`` — pipeline stages (``launch.pipeline``).

The collectives the models and the engine issue are methods here, each
counted in ``Mesh.log`` (by kind and axis; ``Mesh.counts`` by kind) where
it is issued, on a real mesh or a traced one (a CUDA graph's are counted
once at capture, as ``build.LAUNCHES`` counts its launches). The host's
decisions go through :meth:`Mesh.agree` (a ``max`` or ``or`` of a short
vector over every rank) and :meth:`Mesh.share` (the lead rank's object on
every rank): outside any graph, counted apart in ``Mesh.agreements``, so
that a step's collective counts do not move with them. The ``tp_*``
methods are the Megatron pairs: under autograd ``tp_enter`` is identity
forward and a sum over ``tp`` backward, ``tp_sum`` the reverse, ``tp_cat``
an all-gather forward and this rank's slice backward.

``make_production_mesh`` returns an abstract mesh (shape and names, no
process group) for the specs; with ``trace=True`` (and :func:`trace_mesh`
for any shape) a traced mesh for the dry run: this rank is the mesh's
first coordinate, there is no process group, and every collective records
its kind, payload bytes and group size (the profiler's hook
:data:`COLLECTIVE_HOOK`) and returns a tensor of the right shape without
moving data. The port is SPMD (every rank runs the same ops on its own
shard), so one traced rank's step is the per-rank program. The
reference's TPU v5e constants do not carry over: the H100 datasheet's
stand in their place.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch


class Mesh:
    """A grid of global ranks with named axes.

    ``shape`` maps axis name -> size in axis order (as ``jax``'s
    ``Mesh.shape``); ``ranks`` is the numpy grid of global ranks (None for
    an abstract mesh); ``coords`` this rank's index along each axis (None
    where this rank is left out of the mesh or the mesh is abstract);
    ``groups`` this rank's subgroup along each axis; ``group_all`` the
    subgroup of every rank in the mesh."""

    def __init__(self, axis_names, sizes, ranks=None, coords=None,
                 groups=None, group_all=None, backend=None,
                 traced: bool = False):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.ranks = ranks
        self.coords = coords
        self.groups = groups or {}
        self.group_all = group_all
        self.backend = backend
        self.traced = traced
        self.log: collections.Counter = collections.Counter()
        self.agreements = 0  # agree() and share() calls

    @property
    def counts(self) -> dict:
        """The collectives issued so far, by kind."""
        out = dict.fromkeys(("all_reduce", "all_gather", "reduce_scatter"),
                            0)
        for (kind, _axis), n in self.log.items():
            out[kind] += n
        return out

    def __repr__(self) -> str:
        dims = "x".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({dims}, backend={self.backend}, coords={self.coords})"

    # -- this rank's place ---------------------------------------------------
    def index(self, axis: str) -> int:
        if self.coords is None:
            raise ValueError(f"this rank is not in {self!r}")
        return self.coords[axis]

    @property
    def lead(self) -> bool:
        """Is this rank the mesh's lead (every coordinate 0): the one that
        writes what the mesh writes once (a journal, a checkpoint, a
        library)?"""
        return self.coords is not None and not any(self.coords.values())

    @property
    def tp_axis(self) -> str | None:
        """The tensor-parallel axis: ``tp`` on a serve mesh, ``model`` on a
        training mesh."""
        for ax in ("tp", "model"):
            if ax in self.shape:
                return ax
        return None

    @property
    def tp(self) -> int:
        ax = self.tp_axis
        return 1 if ax is None else self.shape[ax]

    @property
    def tp_rank(self) -> int:
        ax = self.tp_axis
        return 0 if ax is None else self.index(ax)

    def check_device(self, device: torch.device) -> None:
        """``ValueError`` unless this mesh's groups can carry tensors on
        ``device``: NCCL for a CUDA device, gloo for the CPU. There is no
        silent gloo on the card."""
        if self.ranks is None and not self.traced:
            raise ValueError("an abstract mesh (make_production_mesh) has no "
                             "process group to run on")
        if self.coords is None:
            raise ValueError(f"this rank is not in {self!r}")
        if self.traced:
            return
        want = "nccl" if device.type == "cuda" else "gloo"
        if want not in str(self.backend):
            raise ValueError(f"a {device.type} mesh needs the {want} "
                             f"backend, the process group is "
                             f"{self.backend!r}")

    # -- collectives -------------------------------------------------------
    def _group(self, axis: str | None):
        return self.group_all if axis is None else self.groups[axis]

    def group_size(self, axis: str | None) -> int:
        return (math.prod(self.shape.values()) if axis is None
                else self.shape[axis])

    def _issued(self, kind: str, axis: str | None, out: torch.Tensor) -> None:
        """Count one collective of ``kind`` over ``axis`` whose result
        buffer is ``out`` (``log``, the profiler's hook)."""
        self.log[(kind, axis or "all")] += 1
        if COLLECTIVE_HOOK is not None and self.traced:
            COLLECTIVE_HOOK(kind, out, self.group_size(axis))

    def all_reduce(self, x: torch.Tensor, axis: str | None,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` in place over ``axis`` (None: the whole mesh) and
        return it; issued whatever the group's size."""
        if not self.traced:
            import torch.distributed as dist

            ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                   "max": dist.ReduceOp.MAX}
            dist.all_reduce(x, op=ops[op], group=self._group(axis))
        self._issued("all_reduce", axis, x)
        return x

    def all_gather(self, x: torch.Tensor, axis: str | None,
                   dim: int = 0) -> torch.Tensor:
        """``x`` of every rank of ``axis``, concatenated along ``dim`` in
        the axis's order."""
        n = self.group_size(axis)
        x = x.contiguous()
        flat = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        if not self.traced:
            import torch.distributed as dist

            gather = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
            gather(flat, x.reshape(-1), group=self._group(axis))
        self._issued("all_gather", axis, flat)
        d = dim % x.dim()
        out = flat.view(n, *x.shape).movedim(0, d)
        return out.reshape(*x.shape[:d], n * x.shape[d], *x.shape[d + 1:])

    def reduce_scatter(self, x: torch.Tensor, axis: str | None,
                       dim: int = 0) -> torch.Tensor:
        """The sum of ``x`` over ``axis``, cut into the group's size along
        ``dim``: this rank's chunk (the inverse of :meth:`all_gather`'s
        layout)."""
        n = self.group_size(axis)
        d = dim % x.dim()
        if x.shape[d] % n:
            raise ValueError(f"axis of {x.shape[d]} does not split into "
                             f"{n} chunks")
        # the chunks laid out one after another, as all_gather reads them
        src = x.reshape(*x.shape[:d], n, x.shape[d] // n,
                        *x.shape[d + 1:]).movedim(d, 0).contiguous()
        out = torch.empty(src.shape[1:], dtype=x.dtype, device=x.device)
        if not self.traced:
            import torch.distributed as dist

            scatter = (getattr(dist, "reduce_scatter_single", None)
                       or dist.reduce_scatter_tensor)
            scatter(out.reshape(-1), src.reshape(-1),
                    group=self._group(axis))
        self._issued("reduce_scatter", axis, out)
        return out

    # -- host-side agreement ------------------------------------------------
    def _host_group(self, device) -> torch.device:
        """Check that this mesh has a process group; the device its
        host-side collectives run on (default: this rank's card for NCCL,
        the CPU for gloo)."""
        if self.ranks is None:
            raise ValueError(f"{self!r} has no process group to agree over")
        if device is not None:
            return torch.device(device)
        if "nccl" in str(self.backend):
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def agree(self, values, op: str = "max", device=None) -> list:
        """``values`` (numbers; bools with ``op="or"``) reduced elementwise
        over every rank of the mesh: the same list on every rank, floats
        for ``"max"``, bools for ``"or"``. One all-reduce of a float64
        vector on ``device``, read back on the host; it raises where the
        reduction fails, and no rank goes on with its own reading. Counted
        in ``agreements``, not in ``log``."""
        import torch.distributed as dist

        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self._host_group(device))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group_all)
        self.agreements += 1
        vals = t.cpu().tolist()
        return [v != 0 for v in vals] if op == "or" else vals

    def share(self, obj, device=None):
        """The lead rank's ``obj`` (any picklable value) on every rank of
        the mesh; the other ranks' ``obj`` is ignored. Counted in
        ``agreements``."""
        import torch.distributed as dist

        box = [obj if self.lead else None]
        dist.broadcast_object_list(box, src=int(self.ranks.reshape(-1)[0]),
                                   group=self.group_all,
                                   device=self._host_group(device))
        self.agreements += 1
        return box[0]

    # -- the Megatron pairs (autograd-aware; plain collectives otherwise) ----
    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; under autograd the gradient is summed over ``tp`` (the
        input of a column-parallel product)."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Enter.apply(x, self)
        return x

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ``tp`` (the output of a row-parallel product). ``x``
        must be this caller's own tensor: outside autograd it is reduced in
        place."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Sum.apply(x, self)
        return self.all_reduce(x, self.tp_axis)

    def tp_cat(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every ``tp`` rank's ``x`` concatenated along ``dim`` (a
        vocab-parallel head's logits)."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Cat.apply(x, self, dim)
        return self.all_gather(x, self.tp_axis, dim)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(),
                                   ctx.mesh.tp_axis), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.contiguous().clone(), mesh.tp_axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Cat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim % x.dim(), x.shape[dim]
        return mesh.all_gather(x, mesh.tp_axis, dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.tp_rank
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

def make_mesh(sizes, axis_names, *, devices=None) -> Mesh:
    """A mesh of ``sizes`` named ``axis_names`` (``jax.make_mesh``'s
    arguments) over the initialized process group's ranks ``devices``
    (default: every rank of the world), row-major as the reference's
    ``reshape``. Every rank creates every line's subgroup in the same
    order; ranks past ``prod(sizes)`` are left out."""
    sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("a device mesh needs an initialized process group "
                         "(torch.distributed.init_process_group)")
    need = math.prod(sizes)
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    if len(ranks) < need:
        raise ValueError(f"mesh {sizes} needs {need} ranks, have "
                         f"{len(ranks)}")
    grid = np.asarray(ranks[:need], dtype=np.int64).reshape(sizes)
    me = dist.get_rank()
    coords, groups = None, {}
    hit = np.argwhere(grid == me)
    if len(hit):
        coords = dict(zip(axis_names, (int(c) for c in hit[0])))
    for i, ax in enumerate(axis_names):
        for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[ax] = g
    group_all = dist.new_group([int(r) for r in grid.reshape(-1)])
    return Mesh(axis_names, sizes, grid, coords, groups,
                group_all if coords is not None else None,
                dist.get_backend())


def trace_mesh(sizes, axis_names) -> Mesh:
    """A traced mesh of ``sizes`` named ``axis_names``: no process group,
    this rank at coordinate 0 of every axis, every collective recorded and
    shaped, never run (module docstring)."""
    axis_names = tuple(axis_names)
    return Mesh(axis_names, sizes, coords={ax: 0 for ax in axis_names},
                traced=True)


def make_production_mesh(*, multi_pod: bool = False,
                         trace: bool = False) -> Mesh:
    """The reference's production mesh, ``(16, 16)`` ``data x model`` or
    ``(2, 16, 16)`` ``pod x data x model``: an abstract shape for the
    specs, or with ``trace=True`` the dry run's traced mesh
    (:func:`trace_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return trace_mesh(shape, axes) if trace else Mesh(axes, shape)


def make_host_mesh(model: int = 1) -> Mesh:
    """``data = world / model`` x ``model`` over every rank of the world
    (the training mesh)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise ValueError("a device mesh needs an initialized process group "
                         "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model-parallel {model} does not divide the "
                         f"world of {n} ranks")
    return make_mesh((n // model, model), ("data", "model"))


def make_serve_mesh(data: int = 1, tp: int = 1, *, devices=None) -> Mesh:
    """Serving mesh ``("data", "tp")``.

    * ``data`` — slot parallelism: rank d of ``data`` holds and decodes
      slots ``[d * S / data, (d + 1) * S / data)`` of the engine's pool.
    * ``tp``   — tensor parallelism: attention heads and the Megatron
      column / row weight shards (``sharding.SERVE_PARAM_RULES``).

    ``devices``: the global ranks to build over (default: the world's);
    ranks beyond ``data * tp`` are left out, as the reference leaves
    devices unused."""
    need = int(data) * int(tp)
    if int(data) < 1 or int(tp) < 1:
        raise ValueError(f"mesh axes must be positive, got {data}x{tp}")
    import torch.distributed as dist

    have = (len(devices) if devices is not None
            else dist.get_world_size() if dist.is_initialized() else 0)
    if have < need:
        raise ValueError(
            f"serve mesh {data}x{tp} needs {need} devices, "
            f"have {have}")
    return make_mesh((int(data), int(tp)), ("data", "tp"), devices=devices)


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """``"2x4"`` -> ``(data=2, tp=4)``; a bare ``"4"`` means ``(4, 1)``."""
    s = spec.strip().lower()
    parts = s.split("x")
    if len(parts) == 1:
        parts = [parts[0], "1"]
    if len(parts) != 2:
        raise ValueError(f"mesh spec {spec!r}: expected 'DATAxTP'")
    try:
        data, tp = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"mesh spec {spec!r}: expected 'DATAxTP'") from None
    if data < 1 or tp < 1:
        raise ValueError(f"mesh spec {spec!r}: axes must be >= 1")
    return data, tp


def init_from_env(device: str | torch.device = "cuda",
                  init_method: str = "env://") -> torch.device:
    """Initialize the default process group from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; the rendezvous
    at ``init_method``, by default ``MASTER_ADDR`` / ``MASTER_PORT``):
    NCCL bound to ``cuda:LOCAL_RANK`` for a CUDA device, gloo for the CPU.
    Returns this rank's device."""
    import datetime
    import os

    import torch.distributed as dist

    from repro_torch.device import resolve

    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = dict(backend="nccl" if dev.type == "cuda" else "gloo",
                  init_method=init_method,
                  rank=int(os.environ.get("RANK", 0)),
                  world_size=int(os.environ.get("WORLD_SIZE", 1)),
                  timeout=datetime.timedelta(seconds=600))
        if dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group(**kw)
    return dev


# Set by ``launch.xprof.profile_step`` while it traces: called with (kind,
# the result buffer, the group size) for every collective a traced mesh
# issues.
COLLECTIVE_HOOK = None

# H100 SXM5 80 GB datasheet values used by the roofline, beside the card
# they were checked against (nvidia-smi --query-gpu=name,power.limit):
# NVIDIA H100 80GB HBM3, 700 W
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 450e9  # bytes/s per card per direction (NVLink 4, 18 links)
# Every 16-way axis of a production mesh spans more than one 8-card HGX
# node, so its collectives cross the per-card network port: one 400 Gb/s
# NDR InfiniBand link per card (NVIDIA DGX H100 datasheet: 8 x ConnectX-7
# for 8 cards), 50 GB/s per direction.
NET_BW = 50e9  # bytes/s per card per direction

