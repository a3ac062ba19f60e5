"""Per-rank op profiler (twin of ``repro/launch/xprof.py``): FLOPs, HBM
bytes, collective bytes and peak live bytes of one rank's step.

The reference parses the compiled HLO of a GSPMD-partitioned program. The
port has no HLO: its program is the aten op stream of one rank's step, and
:func:`profile_step` records that stream. It runs the step on fake tensors
(``torch._subclasses.FakeTensorMode``: shapes and dtypes, no storage, no
device) under a ``TorchDispatchMode`` and counts:

* **flops** — 2 x M x N x K for every matrix product (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``mv``, ``dot``: what ``matmul`` / ``einsum``
  decompose into) and 2 x output elements x (input channels / groups x
  kernel size) for ``convolution``: the quantity the reference counts for
  ``dot`` / ``convolution``. Elementwise FLOPs are not counted.
* **hbm_bytes** — each op's input bytes read plus its output bytes written
  (a broadcast operand's stride-0 axes read once; a gather reads the rows
  it returns, an in-place scatter or ``copy_`` reads its values and writes
  their rows). Views, aliases, ``detach`` and allocations count 0, as the
  reference's ``_NO_TRAFFIC``.
  This differs from the reference's 2 x output bytes on purpose: that
  figure stands in for fused XLA code and leaves out parameter reads,
  which dominate a decode step; the port runs unfused eager ops (and CUDA
  graphs of them), each of which reads its inputs.
* A **port kernel** (``act_lib``, ``rmsnorm_lib``, ``softmax_lib``,
  ``flash_attn_lib``: ``kernels.build.TRACER``) counts as one op: its
  tensor inputs read, its output written, the products it computes (for
  flash attention 2 x (D + Dv) per query-key pair and head: every pair of
  a decode or a non-causal call, the causal triangle of a prefill) and one
  launch under ``kernel_launches``. The intermediates of its plain
  version, which is what runs on fake tensors, do not count.
* **collective bytes and counts** per kind from a traced mesh
  (``launch.mesh.trace_mesh``), with the reference's ring factors on the
  result buffer (groups of one are left out, as the reference's).
* **peak_live_bytes** — the peak of the bytes of live storages the step
  allocated (its arguments left out), the counterpart of
  ``memory_analysis().temp_size_in_bytes``: storages are tracked as they
  are freed, not the caching allocator's reserve.

The layer loop: while :func:`profile_step` traces, ``models.transformer.
backbone`` runs a repeating segment's first step only and the profiler
counts its ops (forward, and backward between the same marks) once per
repeat; ``trip_counts`` lists those repeats, the port's counterpart of the
reference's while-loop trip counts. The live bytes a step leaves behind
(a training layer's saved activations, a prefill's cache) are counted for
each skipped repeat too; in training each skipped layer trades them for
its parameters' gradients as the backward pass reaches it, and the peak
is the last repeat's (the first step's over what the others left). Held
against tracing every layer (``loops=False``): FLOPs, HBM and collective
bytes equal, the peak equal in serving and within 1e-5 in training.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_FACTORS = {
    "all_gather": lambda g: (g - 1) / g,
    "all_reduce": lambda g: 2 * (g - 1) / g,
    "reduce_scatter": lambda g: float(g - 1),  # x output bytes
}

# ops that move no data (besides views, which OpOverload.is_view flags)
_NO_TRAFFIC = {
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "empty",
    "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "set_", "resize_", "_unsafe_view", "view",
    "_reshape_alias", "expand", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "_has_compatible_shallow_copy_type",
}
# ops that write their output and read nothing
_WRITE_ONLY = {"zeros", "ones", "full", "fill_", "zero_", "arange",
               "zeros_like", "ones_like", "full_like", "scalar_tensor",
               "new_zeros", "new_ones", "new_full"}
# gathers: the rows they read are the output's, not the whole source
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# in-place scatters: they read and write the values' rows of ``self``
_SCATTERS = {"index_put_", "index_copy_", "index_add_", "scatter_",
             "scatter_add_", "scatter_reduce_", "masked_scatter_", "copy_"}


def _read_bytes(t: torch.Tensor) -> int:
    """The bytes a read of ``t`` touches: a stride-0 (broadcast) axis once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _mm_flops(name: str, args) -> float:
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    if name in ("dot", "vdot"):
        return 2.0 * args[0].shape[0]
    return 0.0


def _conv_flops(args, out) -> float:
    w = args[1]  # (out channels, in channels / groups, *kernel)
    return 2.0 * out.numel() * w.shape[1] * math.prod(w.shape[2:])


@dataclasses.dataclass
class OpProfile:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_count: dict = dataclasses.field(default_factory=dict)
    trip_counts: list = dataclasses.field(default_factory=list)
    peak_live_bytes: int = 0
    kernel_launches: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(default_factory=dict)  # (op, where) -> row

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def to_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_count": dict(self.collective_count),
                "total_collective_bytes": self.total_collective_bytes,
                "trip_counts": self.trip_counts[:24],
                "peak_live_bytes": self.peak_live_bytes,
                "kernel_launches": dict(self.kernel_launches)}

    def breakdown(self, top: int = 20) -> list[dict]:
        """Per (op, module path) bytes, FLOPs, collective bytes and calls,
        largest bytes + collective bytes first: where the step goes."""
        rows = sorted(self.ops.values(),
                      key=lambda r: -(r["bytes"] + r["coll_bytes"]))
        return rows[:top]


class _Scale(torch.autograd.Function):
    """Identity on ``xs``; sets the profiler's op multiplier to ``fwd`` when
    the forward runs and to ``bwd`` when the backward does (a loop's
    region in both passes). ``box`` (one per loop) carries the loop's
    skipped repeats; the backward pass enters the loop at the exit mark
    and leaves it at the enter mark (``_Profiler.backward_mark``)."""

    @staticmethod
    def forward(ctx, prof, fwd, bwd, box, role, *xs):
        ctx.prof, ctx.bwd, ctx.box, ctx.role = prof, bwd, box, role
        prof.scale = fwd
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.prof.scale = ctx.bwd
        ctx.prof.backward_mark(ctx.box, ctx.role)
        return (None, None, None, None, None, *gs)


class _Skip(torch.autograd.Function):
    """Identity on ``h`` that takes a skipped repeat's layer parameters
    (``leaves``) and ``cross`` as inputs: its backward releases that
    layer's share of the loop's virtual live bytes (its saved activations)
    and hands each a gradient's storage, uncounted (the first step's
    backward, scaled, counts the ops that write them), so the stack of a
    segment's gradients reads every repeat's and the gradient of
    ``cross`` gathers every layer's."""

    @staticmethod
    def forward(ctx, prof, box, j, h, cross, *leaves):
        ctx.prof, ctx.box, ctx.j = prof, box, j
        ctx.shapes = [None if t is None else (t.shape, t.dtype, t.device)
                      for t in (cross, *leaves)]
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        prof, box = ctx.prof, ctx.box
        share = min(max(box["layers"].get(ctx.j, 0), 0), box["n"])
        box["n"] -= share
        prof.virtual -= share
        prof.quiet += 1
        try:
            grads = [None if sh is None else torch.empty(
                sh[0], dtype=sh[1], device=sh[2]) for sh in ctx.shapes]
        finally:
            prof.quiet -= 1
        for k, t in enumerate(grads):
            if t is not None:
                prof._track(t)
                if k:  # a parameter's: live until the segment's stack
                    box["grads"] += t.untyped_storage().nbytes()
        return (None, None, None, g, *grads)


class _Profiler(TorchDispatchMode):
    def __init__(self, prof: OpProfile, skip: set):
        super().__init__()
        self.prof = prof
        self.scale = 1
        self.quiet = 0
        self.live = 0
        self.virtual = 0
        self._storages: dict = {}
        self._skip = skip  # the arguments' storages
        self._marks: list = []
        self._bmarks: list = []
        self._box = None  # the last loop's, for its skipped layers

    # -- live bytes -------------------------------------------------------
    def _peak(self) -> None:
        now = self.live + self.virtual
        self.prof.peak_live_bytes = max(self.prof.peak_live_bytes, now)
        for _, box in self._marks:  # a first step's own peak
            box["peak"] = max(box["peak"], now)
        for box in self._bmarks:  # and its backward's
            box["bpeak"] = max(box["bpeak"], now)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._skip:
            return
        ent = self._storages.get(key)
        if ent is None:
            ent = self._storages[key] = [st.nbytes(), 0]
            self.live += ent[0]
            self._peak()
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        ent = self._storages.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._storages[key]

    # -- counting ---------------------------------------------------------
    def _where(self) -> str:
        f = sys._getframe(2)
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod.startswith("repro_torch") and not mod.startswith(
                    "repro_torch.launch.xprof"):
                return f"{mod[len('repro_torch.'):]}.{f.f_code.co_name}"
            f = f.f_back
        return "(autograd)"

    def _add(self, op: str, where: str, flops: float, byts: float,
             coll: float = 0.0) -> None:
        s = self.scale
        p = self.prof
        p.flops += s * flops
        p.hbm_bytes += s * byts
        row = p.ops.setdefault((op, where), {
            "op": op, "where": where, "calls": 0, "bytes": 0.0,
            "flops": 0.0, "coll_bytes": 0.0})
        row["calls"] += s
        row["bytes"] += s * byts
        row["flops"] += s * flops
        row["coll_bytes"] += s * coll

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten" or self.quiet:
            return out
        for t in _tensors(out):
            self._track(t)
        name = func._opname
        if func.is_view or name in _NO_TRAFFIC:
            return out
        outs = list(_tensors(out))
        ins = list(_tensors([*args, *kwargs.values()]))
        if name in _GATHERS:  # the output's rows read, the indices
            byts = 2 * sum(_read_bytes(t) for t in outs) + sum(
                _read_bytes(t) for t in ins[1:])
        elif name in _SCATTERS:  # the values and indices read, the
            # values' rows written
            rest = sum(_read_bytes(t) for t in ins[1:])
            vals = _read_bytes(ins[-1]) if ins[1:] else 0
            byts = rest + vals
        else:
            byts = sum(_read_bytes(t) for t in outs)
            if name not in _WRITE_ONLY:
                byts += sum(_read_bytes(t) for t in ins)
        flops = (_conv_flops(args, outs[0]) if name == "convolution"
                 else _mm_flops(name, args))
        self._add(name, self._where(), flops, byts)
        return out

    # -- hooks: collectives, kernels, the layer loop --------------------------
    def collective(self, kind: str, out: torch.Tensor, group: int) -> None:
        if group <= 1:
            return
        p = self.prof
        b = _read_bytes(out) * _FACTORS[kind](group) * self.scale
        p.collective_bytes[kind] = p.collective_bytes.get(kind, 0.0) + b
        p.collective_count[kind] = p.collective_count.get(kind, 0) + 1
        row = p.ops.setdefault((kind, self._where()), {
            "op": kind, "where": self._where(), "calls": 0, "bytes": 0.0,
            "flops": 0.0, "coll_bytes": 0.0})
        row["calls"] += self.scale
        row["coll_bytes"] += b

    def kernel(self, name: str, plain, reads, flops: float = 0.0):
        """Run ``plain()`` (the kernel's plain version) uncounted; count one
        op that reads ``reads`` and writes the result."""
        self.quiet += 1
        try:
            out = plain()
        finally:
            self.quiet -= 1
        for t in _tensors(out):  # its intermediates live in the kernel
            self._track(t)
        byts = sum(_read_bytes(t) for t in _tensors(list(reads)))
        byts += sum(_read_bytes(t) for t in _tensors(out))
        self._add(name, "kernel", flops, byts)
        p = self.prof
        p.kernel_launches[name] = p.kernel_launches.get(name, 0) + self.scale
        return out

    def loop_enter(self, h: torch.Tensor, repeat: int, cross=None):
        """A segment's first step begins: ``(h, cross)`` through the loop
        mark (``cross``, the encoder output every layer reads, where its
        gradient is wanted)."""
        self.prof.trip_counts.append(repeat)
        box = {"n": 0, "at": self.live, "layers": {},
               "peak": self.live + self.virtual,
               "in": h.untyped_storage()._cdata}
        self._marks.append((self.live, box))
        if cross is not None and cross.requires_grad:
            h, cross = _Scale.apply(self, repeat, 1, box, "enter", h, cross)
        else:
            h = _Scale.apply(self, repeat, 1, box, "enter", h)[0]
        box["view"] = weakref.ref(h)
        return h, cross

    def layer_done(self, j: str) -> None:
        """Layer ``j`` of a segment's first step ends: the live bytes it
        left behind (a skipped repeat's share, :class:`_Skip`)."""
        box = self._marks[-1][1]
        box["layers"][j] = self.live - box["at"]
        box["at"] = self.live
        if j == "0":  # the peak while the step's input is the loop's
            box["peak0"] = box["peak"]
            box["peak"] = self.live + self.virtual

    def loop_exit(self, h: torch.Tensor, aux: torch.Tensor, repeat: int):
        """The segment's first step ends: what it left live (saved
        activations, a prefill's cache) counts once more for each skipped
        repeat (:class:`_Scale`), and the last repeat's peak is the first
        step's over what the others left. Where the step keeps no
        reference to its input but the caller does, a later repeat frees
        its own input (the previous output) and holds it beside the
        caller's: each repeat then leaves the output's bytes less, and its
        first layer's peak holds them once more."""
        start, box = self._marks.pop()
        held = (box["view"]() is None
                and (box["in"] in self._storages or box["in"] in self._skip))
        out_b = h.untyped_storage().nbytes() if held else 0
        extra = max(self.live - start - out_b, 0) * (repeat - 1)
        self.virtual += extra
        box.update(n=extra, acts=extra, grads=0)
        self._box = box
        p = self.prof
        p.peak_live_bytes = max(p.peak_live_bytes, extra + max(
            box["peak0"] + out_b, box["peak"]))
        self._peak()
        if not aux.requires_grad:  # no MoE aux: no gradient to route
            return _Scale.apply(self, 1, repeat, box, "exit", h)[0], aux
        return _Scale.apply(self, 1, repeat, box, "exit", h, aux)

    def backward_mark(self, box: dict, role: str) -> None:
        """The backward pass enters a loop's first step (``role`` "exit")
        or leaves it ("enter"). Leaving it, the skipped repeats' virtual
        bytes are released, and the last-processed repeat's peak is the
        first step's backward peak with each other repeat's saved
        activations in place of its gradients where those are larger (the
        first step's backward runs when every other repeat has traded its
        activations for its gradients, :class:`_Skip`)."""
        if role == "exit":
            box["bpeak"] = self.live + self.virtual
            self._bmarks.append(box)
            return
        if self._bmarks and self._bmarks[-1] is box:
            self._bmarks.pop()
            more = max(box["acts"] - box["grads"], 0)
            self.prof.peak_live_bytes = max(self.prof.peak_live_bytes,
                                            box["bpeak"] + more)
        self.virtual -= box["n"]
        box["n"] = 0

    def skip_layer(self, h: torch.Tensor, j: str, leaves: list,
                   cross=None):
        """A skipped repeat's layer ``j`` in training (:class:`_Skip`);
        ``cross`` takes its gradient as well."""
        if cross is not None and cross.requires_grad:
            return _Skip.apply(self, self._box, j, h, cross, *leaves)
        return _Skip.apply(self, self._box, j, h, None, *leaves)


def _fake(tree, mode, memo: dict):
    """``tree`` with every Spec leaf a fake CPU tensor of its shape and
    dtype and every real tensor its fake copy (NamedTuples keep their
    type)."""
    from repro_torch.models.layers import Spec

    if isinstance(tree, Spec):
        with mode:
            return torch.empty(tree.shape, dtype=tree.dtype)
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = mode.from_tensor(tree)
        return memo[id(tree)]
    if isinstance(tree, dict):
        return {k: _fake(v, mode, memo) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fake(v, mode, memo) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake(v, mode, memo) for v in tree)
    return tree


def tensor_bytes(tree) -> int:
    """The bytes of every distinct storage among the tensors (or Spec
    leaves) of ``tree``."""
    from repro_torch.models.layers import Spec
    from repro_torch.util.tree import tree_leaves

    seen, n = set(), 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, Spec):
            n += math.prod(leaf.shape) * leaf.dtype.itemsize
        elif isinstance(leaf, torch.Tensor):
            key = leaf.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                n += _read_bytes(leaf)
    return n


def profile_step(fn, *args, loops: bool = True, **kwargs):
    """Run ``fn(*args, **kwargs)`` on fake tensors and profile it (module
    docstring). Spec leaves among the arguments become fake CPU tensors of
    their shape and dtype, real tensors fake copies (a real tensor the step
    reads must lie on the CPU, as a library's ROM for a served kernel's
    plain version); nothing is allocated and nothing runs on a device.
    ``loops=False`` runs every layer of the layer loop. Returns
    ``(OpProfile, the step's output on fake tensors)``; a mesh the step
    collects over must be a traced one (``launch.mesh.trace_mesh``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as tf
    from repro_torch.util.tree import tree_leaves

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    memo: dict = {}
    fargs = _fake(list(args), mode, memo)
    fkw = _fake(kwargs, mode, memo)
    skip = {t.untyped_storage()._cdata
            for t in tree_leaves([fargs, fkw]) if isinstance(t, torch.Tensor)}
    prof = OpProfile()
    counter = _Profiler(prof, skip)
    saved = (tf.TRACER, build.TRACER, mesh_mod.COLLECTIVE_HOOK)
    tf.TRACER = counter if loops else None
    build.TRACER = counter
    mesh_mod.COLLECTIVE_HOOK = counter.collective
    try:
        with mode, counter:
            out = fn(*fargs, **fkw)
    finally:
        tf.TRACER, build.TRACER, mesh_mod.COLLECTIVE_HOOK = saved
    return prof, out
