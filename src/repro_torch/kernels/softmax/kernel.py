"""CUDA wrappers of ``softmax_lib`` and ``softmax_tab`` (``csrc/softmax.cu``),
the ports of ``repro/kernels/softmax/kernel.py`` ``fused_softmax_lib`` /
``_softmax_lib_kernel`` and ``fused_softmax`` / ``_softmax_kernel``. The
reference needs rows % 8 and D % 128; the kernels take any row count and any
D. Both entries run one body at the launch shape ``launch_shape`` gives."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interp.kernel import design_args, slot_args

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("vector", "masked")
# threads the card holds at once (132 SMs x 1024): a call that would take
# more, one chunk a thread, takes four chunks a thread instead
BUSY = 1 << 17


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=256)
def launch_shape(rows: int, d: int, itemsize: int, vector: bool,
                 tpr: int | None = None) -> tuple[int, int, int, int]:
    """(vector, threads per row, chunks per thread, rows per block) of one
    launch: a chunk is one 16-byte vector of x on the vector body, one
    element on the masked one. Threads per row are a power of two (the
    kernel indexes by shifts): by default one thread a chunk up to 512
    threads (rows of at most 16 chunks share a warp: the router's 64
    float32 logits are 16 threads), and a thread up to 8 chunks beyond (a
    row of more than 4096 chunks is read in passes); where rows x threads
    would exceed ``BUSY`` a thread takes four chunks (at least 32 threads a
    row). ``tpr`` (a power of two up to 1024) overrides the threads per
    row. Blocks hold 128 threads, or one row of more; a block whose threads
    hold 32 elements or more at most 512 (the kernel's register budget).
    Chosen from every thread count timed at the main-path shapes on an H100
    (chip_smoke.py ``tpr_graph_ms``)."""
    vec = 16 // itemsize if vector else 1
    chunks = d // vec
    if tpr is None:
        tpr = min(512, _pow2_at_least(chunks))
        if tpr > 16 and rows * tpr > BUSY:
            tpr = max(32, _pow2_at_least(-(-chunks // 4)))
    if not (0 < tpr <= 1024 and tpr & (tpr - 1) == 0):
        raise ValueError(f"threads per row {tpr}: a power of two up to 1024")
    nv = next((n for n in (1, 2, 4, 8) if n * tpr >= chunks), 8)
    if nv * vec >= 32 and tpr > 512:
        raise ValueError(f"{tpr} threads per row with {nv * vec} elements "
                         f"each: at most 512")
    return int(vector), tpr, nv, max(1, 128 // tpr)


def vector_ok(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the vector body takes these operands: D a multiple of x's
    16-byte vector and both pointers 16-byte aligned (so is every row
    start)."""
    return (x.shape[1] % (16 // x.element_size()) == 0
            and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)


def _operands(name: str, x: torch.Tensor, return_e: bool,
              body: str | None, tpr: int | None, lut: bool | None):
    """x made contiguous, its output, with ``return_e`` the float32 e
    buffer, and the int[5] launch shape (``launch_shape`` and the table of
    outputs): ``body`` forces ``"vector"`` (raises where the operands do
    not allow it) or ``"masked"``, by default the vector body wherever it
    applies; ``lut`` forces the float table of exp2neg outputs on or off
    (on: rows of at most 512 threads and a slot of at most 13 bits), by
    default the kernel builds it where a call has 256 elements per code.
    Raises before anything is built."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, D), got {tuple(x.shape)}")
    if body not in (None, *BODIES):
        raise ValueError(f"body {body!r}: one of {BODIES}")
    x = x.contiguous()
    out = torch.empty_like(x)
    vector = vector_ok(x, out)
    if body == "vector" and not vector:
        raise ValueError(f"the vector body needs D % {16 // x.element_size()}"
                         f" == 0 and 16-byte aligned operands")
    shape = _shape_array(x.shape[0], x.shape[1], x.element_size(),
                         vector and body != "masked", tpr,
                         -1 if lut is None else int(bool(lut)))
    if lut and shape[1] > 512:
        raise ValueError(f"the table of outputs takes rows of at most 512 "
                         f"threads, not {shape[1]}")
    if not x.is_cuda:
        raise ValueError(f"{name} launches on a CUDA tensor, x is on "
                         f"{x.device} (the plain version serves the CPU)")
    e = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
         if return_e else None)
    return x, out, e, shape


@functools.lru_cache(maxsize=256)
def _shape_array(rows, d, itemsize, vector, tpr, lut):
    """``launch_shape`` and the table mode as the C entry reads them (built
    once per shape: the served decode step calls the router softmax once
    per MoE layer)."""
    return build.int_array(launch_shape(rows, d, itemsize, vector, tpr)
                           + (lut,))


def softmax_lib_cuda(x: torch.Tensor, library, return_e: bool = False, *,
                     body: str | None = None, tpr: int | None = None,
                     lut: bool | None = None):
    """x: (rows, D) float32 or bfloat16 on CUDA; the exp2neg and recip
    tables read from ``library``'s ROM. Returns the softmax over the last
    axis in x's dtype, and with ``return_e`` also the float32 exp terms e
    (before the reciprocal scale) for bit-exact checks. ``body``, ``tpr``
    and ``lut`` override the launch (``_operands``)."""
    x, out, e, shape = _operands("softmax_lib", x, return_e, body, tpr, lut)
    dev = x.device
    rom = library.coeffs
    if rom.device != dev:
        raise ValueError(f"library ROM on {rom.device}, x on {dev}")
    if x.numel() == 0:
        return (out, e) if return_e else out
    rc = build.load().repro_softmax_lib(
        x.data_ptr(), out.data_ptr(), None if e is None else e.data_ptr(),
        x.shape[0], x.shape[1], _DTYPES[x.dtype], rom.data_ptr(),
        library.walk_rows()[1].data_ptr(),
        build.int_array(slot_args(library, "exp2neg")),
        build.int_array(slot_args(library, "recip")), shape,
        dev.index or 0, build.stream_of(dev))
    build.check("softmax_lib", rc)
    build.LAUNCHES["softmax_lib"] += 1
    return (out, e) if return_e else out


def softmax_tab_cuda(x: torch.Tensor, exp_design, recip_design,
                     return_e: bool = False, *, body: str | None = None,
                     tpr: int | None = None, lut: bool | None = None):
    """The per-table softmax: x (rows, D) float32 or bfloat16 on CUDA; the
    exp table read from ``exp_design``'s own (2^R, 3) coefficients, the
    reciprocal from ``recip_design``'s (``device_coeffs``, which raises for
    a design that exceeds int32). The two designs may differ in R and in
    their widths. Returns as :func:`softmax_lib_cuda`; raises if the two
    tables do not fit one block's shared memory."""
    x, out, e, shape = _operands("softmax_tab", x, return_e, body, tpr, lut)
    dev = x.device
    ec = exp_design.device_coeffs(dev)
    rc = recip_design.device_coeffs(dev)
    if x.numel() == 0:
        return (out, e) if return_e else out
    ret = build.load().repro_softmax_tab(
        x.data_ptr(), out.data_ptr(), None if e is None else e.data_ptr(),
        x.shape[0], x.shape[1], _DTYPES[x.dtype], ec.data_ptr(),
        build.int_array(design_args(exp_design)), rc.data_ptr(),
        build.int_array(design_args(recip_design)), shape, dev.index or 0,
        build.stream_of(dev))
    build.check("softmax_tab", ret)
    build.LAUNCHES["softmax_tab"] += 1
    return (out, e) if return_e else out
