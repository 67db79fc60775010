"""Mamba2 block — SSD (state-space duality), chunked algorithm (port of
:mod:`repro.models.ssm`).

Per head h with scalar decay a_t = exp(dt_t * A_h)  (A_h = -exp(A_log)):

    state_t = a_t * state_{t-1} + dt_t * B_t  x_t^T      ([N, P] outer)
    y_t     = C_t . state_t + D_h * x_t

The block takes one B/C group (``models.build`` refuses ``ssm_groups``
other than 1: ROADMAP.md, R7).  Training and prefill run the scan through
the SSD wrapper (:func:`repro_torch.kernels.ssd_scan.ops.ssd`: the CUDA
kernel on the card, differentiated through the VJP of
:func:`ssd_chunked`; on the CPU :func:`ssd_chunked`, the chunked closed form the
reference's model runs, arXiv:2405.21060 §6).  Decode carries
(conv_state, ssm_state [B, H, P, N]) and takes one recurrence step.

Unlike the reference, :func:`ssd_chunked` takes any sequence length: it
pads the last chunk with dt = 0 and x = 0 (decay exp(0) = 1, update 0, so
the real rows and the final state are unchanged) and drops the padded
rows.  The reference asserts ``S % chunk == 0`` and so cannot prefill a
prompt longer than ``ssm_chunk`` whose length is not a multiple of it
(ROADMAP.md queue 3, R6).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import sharding
from repro_torch.models.layers import cast, rmsnorm, row_parallel
from repro_torch.models.rglru import _conv1d
from repro_torch.models.schema import Leaf


def ssm_schema(cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.d_inner
    g, n, nh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    d_conv = di + 2 * g * n
    d_proj = 2 * di + 2 * g * n + nh
    return {
        "in_proj": Leaf((d, d_proj), ("embed", "ssm_inner")),
        "conv_w": Leaf((cfg.conv_width, d_conv), ("conv", "ssm_inner"),
                       init="fan_in"),
        "conv_b": Leaf((d_conv,), ("ssm_inner",), init="zeros"),
        "a_log": Leaf((nh,), (None,), init="ones"),
        "d_skip": Leaf((nh,), (None,), init="ones"),
        "dt_bias": Leaf((nh,), (None,), init="zeros"),
        "norm_scale": Leaf((di,), ("ssm_inner",), init="ones"),
        "out_proj": Leaf((di, d), ("ssm_inner", "embed")),
    }


def _segsum(log_a):
    """log_a: [..., Q] -> cumulative decay matrix [..., Q, Q]:
    out[i, j] = sum_{k=j+1..i} log_a[k]  (lower triangular, -inf above)."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]        # sum_{j+1..i}
    idx = torch.arange(q, device=log_a.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                device=log_a.device))


def ssd_chunked(x, dt, b, c, a_log_neg, chunk: int, init_state=None):
    """Chunked SSD scan.

    x:  [B, S, H, P]   (inputs per head)
    dt: [B, S, H]      (softplus-ed step sizes, fp32)
    b:  [B, S, G, N]   c: [B, S, G, N]   (G groups broadcast over H)
    a_log_neg: [H]     (A = -exp(a_log))
    Any S: a ragged last chunk is padded with dt = 0, x = 0.
    Returns (y [B, S, H, P], final_state [B, H, P, N]).
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    pad = -s % chunk
    if pad:
        grow = lambda t: torch.cat([t, t.new_zeros(
            (bsz, pad) + tuple(t.shape[2:]))], dim=1)
        x, dt, b, c = grow(x), grow(dt), grow(b), grow(c)
    sp = s + pad
    nc = sp // chunk
    hg = h // g                                # heads per group

    xf = x.float()
    dtf = dt.float()
    a = -torch.exp(a_log_neg.float())                     # [H] negative
    da = dtf * a                                          # [B, S, H] log-decay
    xdt = xf * dtf[..., None]                             # dt-scaled input

    def resh(t, extra):
        return t.reshape((bsz, nc, chunk) + extra)

    xc = resh(xdt, (h, p))
    dac = resh(da, (h,))
    bc = resh(b.float(), (g, n))
    cc = resh(c.float(), (g, n))

    # --- intra-chunk (diagonal block): y = (C B^T . L) x -------------------
    lmat = torch.exp(_segsum(torch.movedim(dac, -1, 2)))  # [B, nc, H, Q, Q]
    # scores[b,l,h,i,j] = C_i . B_j  (broadcast G over H)
    cbh = torch.einsum("blqgn,blkgn->blgqk", cc, bc)      # [B,nc,G,Q,Q]
    cbh = torch.repeat_interleave(cbh, hg, dim=2)         # [B,nc,H,Q,Q]
    y_diag = torch.einsum("blhqk,blhqk,blkhp->blqhp", cbh, lmat, xc)

    # --- per-chunk final states -------------------------------------------
    da_cum = torch.cumsum(dac, dim=2)                     # [B,nc,Q,H]
    da_tot = da_cum[:, :, -1, :]                          # [B,nc,H]
    decay_to_end = torch.exp(da_tot[:, :, None, :] - da_cum)  # [B,nc,Q,H]
    # states[b,l,h,n,p] = sum_q decay * B_q x_q^T
    states = torch.einsum("blqhn,blqh,blqhp->blhnp",
                          torch.repeat_interleave(bc, hg, dim=3),
                          decay_to_end, xc)

    # --- inter-chunk recurrence over chunk states --------------------------
    if init_state is None:
        st = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device)
    else:
        st = torch.swapaxes(init_state.float(), -1, -2)
    prev = []
    for l in range(nc):
        prev.append(st)
        st = states[:, l] + torch.exp(da_tot[:, l])[..., None, None] * st
    prev_states = torch.stack(prev, dim=1)                # [B,nc,H,N,P]

    # --- inter-chunk contribution: y += C . (decay_in * prev_state) --------
    decay_in = torch.exp(da_cum)                          # [B,nc,Q,H]
    if g == 1:
        y_off = torch.einsum("blqgn,blqh,blhnp->blqhp", cc, decay_in,
                             prev_states)
    else:
        y_off = torch.einsum("blqhn,blqh,blhnp->blqhp",
                             torch.repeat_interleave(cc, hg, dim=3),
                             decay_in, prev_states)

    y = (y_diag + y_off).reshape(bsz, sp, h, p)[:, :s]
    return y, torch.swapaxes(st, -1, -2)                  # [B,H,P,N]


def _heads(cfg: ModelConfig, ctx):
    """This rank's SSD heads ``(h0, h1)``: its block under 'model' ranks,
    else all of them."""
    nh = cfg.ssm_heads
    if not sharding.active(ctx) or ctx.tp_size() == 1:
        return 0, nh
    if nh % ctx.tp_size():
        raise ValueError(f"{cfg.name}: {nh} SSD heads do not split over "
                         f"{ctx.tp_size()} 'model' ranks")
    n = nh // ctx.tp_size()
    return ctx.tp_index() * n, (ctx.tp_index() + 1) * n


def _gated_norm(y, scale, cfg: ModelConfig, ctx, tp: bool):
    """RMSNorm over all of ``d_inner``: under 'model' ranks each holds its
    heads' channels, and the sum of squares is summed over 'model' in
    f32."""
    if not tp:
        return rmsnorm({"scale": scale}, y, cfg.norm_eps)
    yf = y.float()
    ss = torch.sum(torch.square(yf), dim=-1, keepdim=True)
    ss = sharding.enter_tp(sharding.leave_tp(ss, ctx), ctx)
    yn = yf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (yn * scale.float()).to(y.dtype)


def ssm_block(params, x, cfg: ModelConfig, state: Tuple = None,
              decode: bool = False, ctx=None):
    """x: [B, S, d] -> (out [B, S, d], new_state (conv, ssm)).

    Under 'model' ranks the rank runs its block of the SSD heads.  The
    fused ``in_proj`` columns ``[z | x | B | C | dt]`` split contiguously,
    which does not follow the heads, so the rank's products are gathered
    over 'model' and re-sliced: its heads' ``z``, ``x`` and ``dt`` and all
    of ``B`` and ``C`` (the conv weights likewise); the gated norm sums
    its squares over 'model'; ``out_proj`` is row-parallel.  The conv
    state stays whole (the gathered inputs' last W-1 rows, the same bits
    on every rank) and the SSM state is the rank's heads."""
    di, g, n, nh, p = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_head_dim)
    d_conv = di + 2 * g * n
    h0, h1 = _heads(cfg, ctx)
    tp = (h0, h1) != (0, nh)
    w = cast(params["in_proj"])
    cw, cb = cast(params["conv_w"]), cast(params["conv_b"])
    hp = lambda t: t
    if tp:
        if w.shape[1] != 2 * di + 2 * g * n + nh:
            proj = sharding.gather_tp(torch.matmul(
                sharding.enter_tp(x, ctx), w), ctx, -1, summed=True)
        else:
            proj = sharding.enter_tp(torch.matmul(x, w), ctx)
        if cw.shape[1] != d_conv:
            cw = sharding.gather_tp(cw, ctx, 1, summed=True)
            cb = sharding.gather_tp(cb, ctx, 0, summed=True)
        else:
            cw, cb = sharding.enter_tp(cw, ctx), sharding.enter_tp(cb, ctx)
        hp = lambda t: sharding.enter_tp(t, ctx)[h0:h1]
    else:
        proj = torch.matmul(x, w)
    bsz, s = x.shape[0], x.shape[1]
    z, xbc, dt_raw = torch.split(proj, [di, d_conv, nh], dim=-1)
    c0, c1 = h0 * p, h1 * p
    z, dt_raw = z[..., c0:c1], dt_raw[..., h0:h1]

    conv_state = state[0] if state is not None else None
    if tp:
        sel = torch.cat([torch.arange(c0, c1, device=x.device),
                         torch.arange(di, d_conv, device=x.device)])
        pad = xbc.new_zeros((bsz, cfg.conv_width - 1, d_conv)) \
            if conv_state is None else conv_state.to(xbc.dtype)
        new_conv = torch.cat([pad, xbc], dim=1)[:, -(cfg.conv_width - 1):]
        xbc, _ = _conv1d(xbc[..., sel], cw[:, sel], cb[sel], pad[..., sel])
    else:
        xbc, new_conv = _conv1d(xbc, cw, cb, conv_state)
    xbc = F.silu(xbc)
    nl = h1 - h0
    xs, b, c = torch.split(xbc, [nl * p, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, s, nl, p)
    b = b.reshape(bsz, s, g, n)
    c = c.reshape(bsz, s, g, n)
    a_log, d_skip = hp(params["a_log"]), hp(params["d_skip"])
    dt = F.softplus(dt_raw.float() + hp(params["dt_bias"]).float())

    if decode:
        ssm_state = state[1]                              # [B, H, P, N] fp32
        a = -torch.exp(a_log.float())
        da = torch.exp(dt[:, 0] * a)                      # [B, H]
        bx = torch.einsum("bhp,bn->bhpn",
                          (xs[:, 0] * dt[:, 0, :, None]).float(),
                          b[:, 0, 0].float())
        new_ssm = da[..., None, None] * ssm_state + bx
        y = torch.einsum("bhpn,bn->bhp", new_ssm, c[:, 0, 0].float())
        y = y[:, None]                                    # [B, 1, H, P]
    else:
        init = state[1] if state is not None else None
        y, new_ssm = ssd_ops.ssd(xs, dt, b[:, :, 0], c[:, :, 0],
                                 a_log, min(cfg.ssm_chunk, s), init)

    y = y + d_skip.float()[None, None, :, None] * xs.float()
    y = y.reshape(bsz, s, nl * p).to(x.dtype)
    y = y * F.silu(z)                                     # gated
    y = _gated_norm(y, params["norm_scale"], cfg, ctx, tp)
    if tp:
        return row_parallel(y, params["out_proj"], ctx), (new_conv, new_ssm)
    out = torch.matmul(y, cast(params["out_proj"]))
    return out, (new_conv, new_ssm)


def init_state(cfg: ModelConfig, batch: int, device):
    d_conv = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return (torch.zeros((batch, cfg.conv_width - 1, d_conv),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32,
                        device=device))
