"""CUDA wrappers of ``flash_attn_lib`` and ``flash_attn_tab``
(``csrc/flashattn.cu``), the ports of ``repro/kernels/flashattn/kernel.py``
``flash_attention_lib`` / ``_flash_lib_kernel`` and ``flash_attention`` /
``_flash_kernel`` (positions ``arange``, one KV head per query head, each
table from its own design).

One block serves the g = H / KVH query heads of a KV head for ``tq`` query
positions (g * tq <= 64 rows), so every K/V tile it streams is read once per
group. Where those blocks are too few to fill the card (decode: one query
tile per (batch, KV head)), :func:`kv_splits` cuts the key tiles into
ranges, one block each; the blocks write their running (m, l, acc) to an
f32 workspace allocated here and a second kernel combines them with the
exp2neg table. Tensors are passed by strides: q and out in the caller's
(B, S, H, D) layout, K/V as views of the (B, KVH, S, D) cache or of the
prompt's (B, S, KVH, D) projections, without copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.interp.kernel import design_args, slot_args

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 64  # query rows per block
MAX_ACC = 8192  # rows * Dv accumulators per block (32 per thread)
BLOCK_K = 64  # keys per tile
SMS = 132  # streaming multiprocessors of an H100 SXM


def query_tile(sq: int, g: int, dv: int) -> int:
    """Query positions per block: fill up to MAX_ROWS rows of g heads."""
    if g > MAX_ROWS or g * dv > MAX_ACC:
        raise ValueError(f"flash_attn_lib: kv group {g} x Dv {dv} exceeds "
                         f"one block ({MAX_ROWS} rows, {MAX_ACC} accumulators)")
    return max(1, min(sq, MAX_ROWS // g, MAX_ACC // (g * dv)))


def kv_splits(b: int, kvh: int, n_qt: int, sk: int) -> int:
    """Key ranges per (batch, KV head, query tile): 1 where the blocks
    already fill the card's SMs or there are several query tiles (prefill);
    else enough ranges for about two blocks per SM, each range at least two
    ``BLOCK_K``-key tiles. A function of the shapes alone (the CPU twin
    calls it); the ranges are ``ceil(n_kt / splits)`` tiles each, and the
    count is trimmed so that no range is empty."""
    n_kt = -(-sk // BLOCK_K)
    blocks = b * kvh * n_qt
    if n_qt != 1 or not 0 < blocks < SMS or n_kt < 4:
        return 1
    want = min(-(-2 * SMS // blocks), n_kt // 2)
    return -(-n_kt // -(-n_kt // want))


def _check(name: str, q, k, v) -> None:
    """Types, devices and the 4-byte rows the kernel reads q, K and V by."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes one dtype of float32 or bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] > 256 or v.shape[-1] > 256:
        raise ValueError(f"head dims {q.shape[-1]}/{v.shape[-1]} exceed 256")
    epw = 2 if q.dtype == torch.bfloat16 else 1
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{n} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{n} needs a contiguous last dim")
    for n, t in (("q", q), ("k", k), ("v", v)):  # read as 32-bit words
        if t.shape[-1] % epw or any(s % epw for s in t.stride()[:3]) \
                or t.data_ptr() % 4:
            raise ValueError(f"{n} rows are not 4-byte aligned")


def _strides(*tensors) -> list[int]:
    """(batch, head, position) element strides of (B, S, H, D) tensors."""
    out = []
    for t in tensors:
        out += [t.stride(0), t.stride(2), t.stride(1)]
    return out


def _workspace(splits: int, b: int, h: int, sq: int, dv: int, dev):
    """The split blocks' (m, l) and acc rows, or null pointers for one
    split (the blocks then write ``out`` themselves)."""
    if splits == 1:
        return None, None
    ml = torch.empty((splits, b, h, sq, 2), dtype=torch.float32, device=dev)
    acc = torch.empty((splits, b, h, sq, dv), dtype=torch.float32,
                      device=dev)
    return ml, acc


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def flash_attn_lib_cuda(q, k, v, q_pos, kv_pos, library, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Sk, KVH, D); v: (B, Sk, KVH, Dv), any
    strides with a contiguous last dim; q_pos (B, Sq), kv_pos (B, Sk) int32
    (-1 = padded row / dead slot). Returns (B, Sq, H, Dv) in v's dtype."""
    b, sq, h, d = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    if h % kvh or k.shape[0] != b or v.shape[:3] != k.shape[:3] \
            or k.shape[-1] != d:
        raise ValueError(f"bad attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    _check("flash_attn_lib", q, k, v)
    dev = q.device
    g = h // kvh
    tq = query_tile(sq, g, dv)
    splits = kv_splits(b, kvh, -(-sq // tq), sk)
    q_pos = q_pos.to(device=dev, dtype=torch.int32).contiguous()
    kv_pos = kv_pos.to(device=dev, dtype=torch.int32).contiguous()
    if q_pos.shape != (b, sq) or kv_pos.shape != (b, sk):
        raise ValueError(f"positions {tuple(q_pos.shape)} / "
                         f"{tuple(kv_pos.shape)} for B={b} Sq={sq} Sk={sk}")
    rom = library.coeffs
    if rom.device != dev:
        raise ValueError(f"library ROM on {rom.device}, q on {dev}")
    out = torch.empty((b, sq, h, dv), dtype=v.dtype, device=dev)
    ws_ml, ws_acc = _workspace(splits, b, h, sq, dv, dev)
    scale = (d ** -0.5) if scale is None else scale
    rc = build.load().repro_flash_attn_lib(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_pos.data_ptr(), kv_pos.data_ptr(), rom.data_ptr(),
        library.walk_rows()[1].data_ptr(),
        build.int_array(slot_args(library, "exp2neg")),
        build.int_array(slot_args(library, "recip")),
        _ptr(ws_ml), _ptr(ws_acc),
        build.int_array(_strides(q, k, v, out), build.ctypes.c_int64),
        build.int_array([b, h, kvh, sq, sk, d, dv, tq, splits, 0]),
        int(causal),
        -1 if window is None else int(window), float(scale),
        _DTYPES[q.dtype], dev.index or 0, build.stream_of(dev))
    build.check("flash_attn_lib", rc)
    build.LAUNCHES["flash_attn_lib"] += 1
    return out


def flash_attn_tab_cuda(q, k, v, exp_design, recip_design, *,
                        causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """The per-table flash attention: q (B, Sq, H, D), k and v (B, Sk, H,
    D), any strides with a contiguous last dim; causal by index (query row i
    sees keys j <= i, top-left aligned when Sq != Sk), skipping the key
    tiles strictly above a query tile's diagonal. p and the running
    correction read ``exp_design``'s own (2^R, 3) coefficients, 1/l
    ``recip_design``'s (``device_coeffs``, which raises for a design that
    exceeds int32). Returns (B, Sq, H, D) in v's dtype."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"bad attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}: K/V need "
                         f"the query's heads and head dim")
    _check("flash_attn_tab", q, k, v)
    dev = q.device
    tq = query_tile(sq, 1, d)
    splits = kv_splits(b, h, -(-sq // tq), sk)
    ec = exp_design.device_coeffs(dev)
    rc = recip_design.device_coeffs(dev)
    out = torch.empty((b, sq, h, d), dtype=v.dtype, device=dev)
    ws_ml, ws_acc = _workspace(splits, b, h, sq, d, dev)
    scale = (d ** -0.5) if scale is None else scale
    ret = build.load().repro_flash_attn_tab(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ec.data_ptr(), build.int_array(design_args(exp_design)),
        rc.data_ptr(), build.int_array(design_args(recip_design)),
        _ptr(ws_ml), _ptr(ws_acc),
        build.int_array(_strides(q, k, v, out), build.ctypes.c_int64),
        build.int_array([b, h, h, sq, sk, d, d, tq, splits, 0]),
        int(causal),
        float(scale), _DTYPES[q.dtype], dev.index or 0, build.stream_of(dev))
    build.check("flash_attn_tab", ret)
    build.LAUNCHES["flash_attn_tab"] += 1
    return out
