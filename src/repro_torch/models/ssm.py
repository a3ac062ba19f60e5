"""Mamba2 (state-space duality) mixer (twin of ``repro/models/ssm.py``):
chunked SSD for prefill and a single-step state update for decode.

Every exponential of the recurrence (the decay factors exp(dt*A), dt >= 0,
A < 0), the dt softplus, the conv and gate SiLUs and the gated RMSNorm run
through the numerics backend, where the reference calls them; ``a =
-exp(a_log)`` is a plain ``torch.exp`` there and here. Each of the
reference's ``einsum(..., preferred_element_type=float32)`` computes in
float32 here, on upcast operands. The recurrent state ``ssm`` is float32,
the ``conv`` shift register has the parameter dtype. The inter-chunk
recurrence (the reference's ``lax.scan``) is a Python loop over chunks.
``ssm_decode`` writes the new state into the state it is handed, in place,
from fresh tensors: what a captured decode graph replays. ``ssm_train`` is
the train path's forward: the prefill's body without its state, every
tensor autograd saves left as it was written.

``mesh=`` (a ``tp > 1`` mesh, ``launch.sharding.ssm_head_parallel``): the
mixer's weights are this rank's heads, segment by segment (``in_proj``'s
z, x and dt of its heads and a ``1 / tp`` slice of B and C; ``conv_w`` /
``conv_b`` the matching channels; ``out_proj`` its heads' rows). B and C
are all-gathered after the conv (every head reads them), the gated norm
reads the whole ``d_inner`` row (all-gathered, then this rank's slice
kept), ``out_proj`` is row-parallel and summed over ``tp``; the conv
window and the recurrent state hold this rank's channels and heads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import pdtype, spec, tp_cols

_F32 = torch.float32


class SSMState(NamedTuple):
    conv: torch.Tensor  # (..., B, d_conv-1, conv_dim) shift register
    ssm: torch.Tensor  # (..., B, H, P, N) float32 recurrent state


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def ssm_shapes(cfg) -> dict:
    s, dt = cfg.ssm, pdtype(cfg)
    d_inner, n_heads, conv_dim = _dims(cfg)
    return {
        "in_proj": spec((cfg.d_model,
                         2 * d_inner + 2 * s.n_groups * s.d_state + n_heads),
                        dt),
        "conv_w": spec((s.d_conv, conv_dim), dt),
        "conv_b": spec((conv_dim,), dt),
        "a_log": spec((n_heads,), _F32),
        "dt_bias": spec((n_heads,), _F32),
        "d_skip": spec((n_heads,), _F32),
        "norm": {"scale": spec((d_inner,), dt)},
        "out_proj": spec((d_inner, cfg.d_model), dt),
    }


def _local_dims(cfg, mesh):
    """(d_inner, heads, n_groups * d_state, conv channels) of this rank:
    the whole mixer's without a mesh, a ``1 / tp`` share of each on
    one."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    tp = 1 if mesh is None else mesh.tp
    di, hl, gl = d_inner // tp, n_heads // tp, gn // tp
    return di, hl, gl, di + 2 * gl


def _split_proj(p: dict, x: torch.Tensor, cfg, mesh=None):
    di, _, _, conv_l = _local_dims(cfg, mesh)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + conv_l]
    dt = zxbcdt[..., di + conv_l:]
    return z, xbc, dt


def _gather_bc(bc: torch.Tensor, cfg, mesh):
    """B and C (..., G, N) each from this rank's ``[B | C]`` slice of the
    conv output: whole on every rank (all-gathered over ``tp``, gradient
    summed over it) on a mesh."""
    s = cfg.ssm
    gn = s.n_groups * s.d_state
    lead = bc.shape[:-1]
    if mesh is not None:
        bc = bc.reshape(*lead, 2, bc.shape[-1] // 2)
        bc = mesh.tp_enter(mesh.tp_cat(bc, dim=-1)).reshape(*lead, 2 * gn)
    return (bc[..., :gn].reshape(*lead, s.n_groups, s.d_state),
            bc[..., gn:].reshape(*lead, s.n_groups, s.d_state))


def _conv_scan(p: dict, xbc: torch.Tensor, cfg, numerics) -> torch.Tensor:
    """Causal depthwise conv over the sequence (prefill path)."""
    k = cfg.ssm.d_conv
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * p["conv_w"][i]
              for i in range(k))
    return numerics.silu(out + p["conv_b"])


def _gated_norm(p: dict, y: torch.Tensor, z: torch.Tensor,
                numerics, mesh=None) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)`` over the whole ``d_inner`` row: on a
    mesh this rank's columns are all-gathered first and its slice of the
    result kept."""
    g = y * numerics.silu(z)
    if mesh is not None:
        g = mesh.tp_cat(g, dim=-1)
    out = numerics.rmsnorm(g, p["norm"]["scale"].to(_F32)).to(y.dtype)
    return out if mesh is None else tp_cols(out, y.shape[-1], mesh)


def ssd_chunked(x, dt, a, b_mat, c_mat, d_skip, cfg, numerics, h0=None):
    """Chunked SSD.

    x: (B,S,H,P); dt: (B,S,H) float32; a: (H,) < 0; b_mat / c_mat:
    (B,S,G,N); h0: (B,H,P,N) or None. Returns (y: (B,S,H,P) in x's dtype,
    h_final: (B,H,P,N) float32). A sequence longer than one chunk must be
    a whole number of chunks (the reference asserts it; no padding path)."""
    s_cfg = cfg.ssm
    bsz, seq, h, p_dim = x.shape
    g = s_cfg.n_groups
    hg = h // g
    n = s_cfg.d_state
    q = min(s_cfg.chunk, seq)
    if seq % q:
        raise ValueError(f"ssd_chunked: sequence length {seq} is not a whole "
                         f"number of {q}-token chunks {(seq, q)}")
    nc = seq // q

    xr = x.reshape(bsz, nc, q, g, hg, p_dim).to(_F32)
    dtr = dt.reshape(bsz, nc, q, h)
    br = b_mat.reshape(bsz, nc, q, g, n).to(_F32)
    cr = c_mat.reshape(bsz, nc, q, g, n).to(_F32)
    dta = dtr * a  # (B,nc,Q,H) <= 0
    cum = torch.cumsum(dta, dim=2)  # within-chunk cumulative decay

    # intra-chunk (quadratic in Q)
    cb = torch.einsum("bcqgn,bcsgn->bcgqs", cr, br)
    seg = cum[..., :, None, :] - cum[..., None, :, :]  # (B,nc,Q,S,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None],
                        numerics.exp_neg(torch.clamp(seg, max=0.0)), 0.0)
    dgr = decay.reshape(bsz, nc, q, q, g, hg)  # (B,nc,Q,S,G,HG)
    # mat[b,c,g,q,s,m] = (C_q.B_s) * exp(cum_q - cum_s) * dt_s
    mat = (cb[..., None] * dgr.permute(0, 1, 4, 2, 3, 5)
           * dtr.reshape(bsz, nc, q, g, hg).permute(0, 1, 3, 2, 4)
           [:, :, :, None])
    y_intra = torch.einsum("bcgqsm,bcsgmp->bcqgmp", mat, xr)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
    to_end = numerics.exp_neg(cum[:, :, -1:, :] - cum)  # arg <= 0
    wts = (to_end * dtr).reshape(bsz, nc, q, g, hg)
    states = torch.einsum("bcqgmp,bcqgn->bcgmpn", wts[..., None] * xr, br)

    # inter-chunk linear recurrence over chunk states
    chunk_decay = numerics.exp_neg(torch.sum(dta, dim=2))  # arg <= 0
    cd = chunk_decay.reshape(bsz, nc, g, hg)
    h_cur = (torch.zeros((bsz, g, hg, p_dim, n), dtype=_F32, device=x.device)
             if h0 is None else h0.reshape(bsz, g, hg, p_dim, n).to(_F32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_cur)
        h_cur = h_cur * cd[:, c, :, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, 1)  # (B,nc,G,HG,P,N)

    # inter-chunk contribution: C_i . (exp(cum_i) * h_prev)
    from_start = numerics.exp_neg(cum).reshape(bsz, nc, q, g, hg)
    y_inter = (torch.einsum("bcqgn,bcgmpn->bcqgmp", cr, h_prev)
               * from_start[..., None])

    y = (y_intra + y_inter).reshape(bsz, seq, h, p_dim)
    y = y + x * d_skip[None, None, :, None]
    return y.to(x.dtype), h_cur.reshape(bsz, h, p_dim, n)


def _ssm_forward(p: dict, x: torch.Tensor, cfg, numerics, h0=None,
                 mesh=None):
    """(output, final state h, the pre-conv ``xbc`` projection)."""
    s = cfg.ssm
    di, hl, gl, _ = _local_dims(cfg, mesh)
    if mesh is not None:
        x = mesh.tp_enter(x)
    z, xbc_in, dt = _split_proj(p, x, cfg, mesh)
    xbc = _conv_scan(p, xbc_in, cfg, numerics)
    bsz, seq, _ = x.shape
    x_ssm = xbc[..., :di].reshape(bsz, seq, hl, s.head_dim)
    b_mat, c_mat = _gather_bc(xbc[..., di:], cfg, mesh)
    dt_f = numerics.softplus(dt.to(_F32) + tp_cols(p["dt_bias"], hl, mesh))
    a = -torch.exp(tp_cols(p["a_log"], hl, mesh))
    y, h_last = ssd_chunked(x_ssm, dt_f, a, b_mat, c_mat,
                            tp_cols(p["d_skip"], hl, mesh), cfg, numerics,
                            h0)
    y = _gated_norm(p, y.reshape(bsz, seq, di), z, numerics, mesh)
    y = y @ p["out_proj"]
    return (y if mesh is None else mesh.tp_sum(y)), h_last, xbc_in


def ssm_train(p: dict, x: torch.Tensor, cfg, numerics,
              mesh=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), no state kept; S longer than one chunk
    must be whole chunks, as in prefill."""
    return _ssm_forward(p, x, cfg, numerics, mesh=mesh)[0]


def ssm_prefill(p: dict, x: torch.Tensor, cfg, numerics, mesh=None):
    """x: (B, S, d). Returns (y, SSMState): the conv state is the last
    ``d_conv - 1`` rows of the pre-conv projection, left-padded with zeros
    for a shorter prompt."""
    k = cfg.ssm.d_conv
    y, h_last, xbc = _ssm_forward(p, x, cfg, numerics, mesh=mesh)
    tail = xbc[:, -(k - 1):, :]
    pad = k - 1 - tail.shape[1]
    if pad > 0:
        tail = F.pad(tail, (0, 0, pad, 0))
    return y, SSMState(conv=tail.contiguous(), ssm=h_last)


def ssm_decode(p: dict, x: torch.Tensor, state: SSMState, cfg, numerics,
               mesh=None):
    """x: (B, 1, d); ``state`` is one layer's (B, ...) view of the pool,
    updated in place and returned."""
    s = cfg.ssm
    di, hl, gl, _ = _local_dims(cfg, mesh)
    bsz = x.shape[0]
    g, n = s.n_groups, s.d_state
    hg = hl // g
    z, xbc, dt = _split_proj(p, x, cfg, mesh)  # (B,1,*)
    window = torch.cat([state.conv, xbc], dim=1)  # (B, d_conv, conv_dim)
    # the reference's dot over the window, accumulated in float32
    conv_out = ((window.to(_F32) * p["conv_w"].to(_F32)).sum(1)
                .to(window.dtype) + p["conv_b"])
    xbc1 = numerics.silu(conv_out)
    x_ssm = xbc1[:, :di].reshape(bsz, hl, s.head_dim)
    b_mat, c_mat = _gather_bc(xbc1[:, di:], cfg, mesh)
    b_mat, c_mat = b_mat.to(_F32), c_mat.to(_F32)
    dt_f = numerics.softplus(dt[:, 0].to(_F32)
                             + tp_cols(p["dt_bias"], hl, mesh))  # (B,H)
    a = -torch.exp(tp_cols(p["a_log"], hl, mesh))
    decay = numerics.exp_neg(dt_f * a)  # exp(dt*A), arg <= 0
    xg = x_ssm.reshape(bsz, g, hg, s.head_dim).to(_F32)
    dtg = dt_f.reshape(bsz, g, hg)
    upd = (dtg[..., None, None] * b_mat[:, :, None, None, :]
           * xg[..., None])  # (B,G,HG,P,N)
    h = state.ssm.reshape(bsz, g, hg, s.head_dim, n)
    h_new = h * decay.reshape(bsz, g, hg)[..., None, None] + upd
    y = torch.einsum("bgn,bgmpn->bgmp", c_mat, h_new)
    y = y.reshape(bsz, hl, s.head_dim) + x_ssm * tp_cols(
        p["d_skip"], hl, mesh)[None, :, None]
    y = _gated_norm(p, y.reshape(bsz, 1, di).to(x.dtype), z, numerics, mesh)
    state.conv.copy_(window[:, 1:])
    state.ssm.copy_(h_new.reshape(bsz, hl, s.head_dim, n))
    y = y @ p["out_proj"]
    return (y if mesh is None else mesh.tp_sum(y)), state


def ssm_state_specs(cfg, b: int, dtype) -> SSMState:
    s = cfg.ssm
    _, n_heads, conv_dim = _dims(cfg)
    return SSMState(conv=spec((b, s.d_conv - 1, conv_dim), dtype),
                    ssm=spec((b, n_heads, s.head_dim, s.d_state), _F32))
