"""CUDA wrappers of ``rmsnorm_lib`` and ``rmsnorm_tab`` (``csrc/rmsnorm.cu``),
the ports of ``repro/kernels/rmsnorm/kernel.py`` ``fused_rmsnorm_lib`` /
``_rmsnorm_lib_kernel`` and ``fused_rmsnorm`` / ``_rmsnorm_kernel``. The
reference needs rows % 8 and D % 128; the kernels take any row count and
any D. gamma goes in as stored, float32 or bfloat16: a model's bf16 norm
scale needs no cast, so a served norm is one device op."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interp.kernel import design_args, slot_args

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("vector", "masked")


@functools.lru_cache(maxsize=256)
def launch_shape(rows: int, d: int, itemsize: int, vector: bool,
                 tpr: int | None = None) -> tuple[int, int, int, int]:
    """(vector, threads per row, chunks per thread, rows per block) of one
    launch: a chunk is one 16-byte vector of x on the vector body, one
    element on the masked one. By default a row gets as many threads as it
    has chunks, at most 256 (the fastest of 64-1024 at every main-path
    shape, decode and prefill alike, on an H100: chip_smoke.py
    ``tpr_graph_ms``), and a thread up to 8 chunks; a row of more than
    2048 chunks gets up to 512 threads, and one of more than 4096 is read
    in passes. ``tpr`` (a multiple of 32) overrides the threads per row.
    Rows narrower than 128 threads share a block. A block of 4 or 8 chunks
    per thread has at most 512 threads."""
    chunks = d // (16 // itemsize) if vector else d
    if tpr is None:
        tpr = min(256, max(32, -(-chunks // 32) * 32))
        if 8 * tpr < chunks:
            tpr = min(512, -(-chunks // 256) * 32)
    if tpr < 32 or tpr % 32 or tpr > 1024:
        raise ValueError(f"threads per row {tpr}: a multiple of 32 in "
                         f"[32, 1024]")
    nv = next((n for n in (1, 2, 4, 8) if n * tpr >= chunks), 8)
    if nv >= 4 and tpr > 512:
        raise ValueError(f"{tpr} threads per row with {nv} chunks each: "
                         f"at most 512")
    return int(vector), tpr, nv, max(1, 128 // tpr)


def vector_ok(x: torch.Tensor, gamma: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the vector body takes these operands: D a multiple of x's
    16-byte vector and every pointer 16-byte aligned (so is every row
    start)."""
    return (x.shape[1] % (16 // x.element_size()) == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, gamma, out)))


def _operands(name: str, x: torch.Tensor, gamma: torch.Tensor):
    """x made contiguous, gamma as given (float32 or bfloat16, on x's
    device, shape (D,)), and the output."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if gamma.dtype not in _DTYPES:
        raise TypeError(f"{name}: gamma must be float32 or bfloat16, not "
                        f"{gamma.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, D), got {tuple(x.shape)}")
    if gamma.shape != (x.shape[1],):
        raise ValueError(f"gamma {tuple(gamma.shape)} for D={x.shape[1]}")
    if gamma.device != x.device:
        raise ValueError(f"gamma on {gamma.device}, x on {x.device}")
    x = x.contiguous()
    return x, gamma.contiguous(), torch.empty_like(x)


def _shape(x, gamma, out, body: str | None, tpr: int | None):
    """The int[4] launch shape (``launch_shape``); ``body`` forces
    ``"vector"`` (raises where the operands do not allow it) or
    ``"masked"``; by default the vector body wherever it applies."""
    if body not in (None, *BODIES):
        raise ValueError(f"body {body!r}: one of {BODIES}")
    vector = vector_ok(x, gamma, out)
    if body == "vector" and not vector:
        raise ValueError(f"the vector body needs D % {16 // x.element_size()}"
                         f" == 0 and 16-byte aligned operands")
    return _shape_array(x.shape[0], x.shape[1], x.element_size(),
                        vector and body != "masked", tpr)


@functools.lru_cache(maxsize=256)
def _shape_array(*key):
    """``launch_shape`` as the C entry reads it (built once per shape: the
    served decode step calls the norm 2 * n_layers + 1 times)."""
    return build.int_array(launch_shape(*key))


def rmsnorm_lib_cuda(x: torch.Tensor, gamma: torch.Tensor, library,
                     eps: float = 1e-6, *, body: str | None = None,
                     tpr: int | None = None) -> torch.Tensor:
    """x: (rows, D) float32 or bfloat16 on CUDA; gamma: (D,) float32 or
    bfloat16; the rsqrt table read from ``library``'s ROM. Output in x's
    dtype. ``body`` and ``tpr`` override the launch (``_shape``)."""
    x, gamma, out = _operands("rmsnorm_lib", x, gamma)
    dev = x.device
    rom = library.coeffs
    if rom.device != dev:
        raise ValueError(f"library ROM on {rom.device}, x on {dev}")
    if x.numel() == 0:
        return out
    rc = build.load().repro_rmsnorm_lib(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], _DTYPES[x.dtype], _DTYPES[gamma.dtype], float(eps),
        rom.data_ptr(), library.walk_rows()[1].data_ptr(),
        build.int_array(slot_args(library, "rsqrt")),
        _shape(x, gamma, out, body, tpr), dev.index or 0,
        build.stream_of(dev))
    build.check("rmsnorm_lib", rc)
    build.launched("rmsnorm_lib", rom)
    return out


def rmsnorm_tab_cuda(x: torch.Tensor, gamma: torch.Tensor, design,
                     eps: float = 1e-6, *, body: str | None = None,
                     tpr: int | None = None) -> torch.Tensor:
    """The per-table RMSNorm: x (rows, D) float32 or bfloat16 on CUDA,
    gamma (D,) float32 or bfloat16; the rsqrt table read from ``design``'s
    own (2^R, 3) coefficients (``device_coeffs``, which raises for a design
    that exceeds int32), its odd/even-exponent split at the design's own
    in_bits. Output in x's dtype."""
    x, gamma, out = _operands("rmsnorm_tab", x, gamma)
    dev = x.device
    coeffs = design.device_coeffs(dev)
    if x.numel() == 0:
        return out
    rc = build.load().repro_rmsnorm_tab(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], _DTYPES[x.dtype], _DTYPES[gamma.dtype], float(eps),
        coeffs.data_ptr(), build.int_array(design_args(design)),
        _shape(x, gamma, out, body, tpr), dev.index or 0,
        build.stream_of(dev))
    build.check("rmsnorm_tab", rc)
    build.LAUNCHES["rmsnorm_tab"] += 1
    return out
