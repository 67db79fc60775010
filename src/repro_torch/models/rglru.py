"""RG-LRU recurrent block (Griffin / RecurrentGemma) — port of
:mod:`repro.models.rglru`.

    i_t = sigmoid(W_i x_t)                  (input gate, block-diagonal)
    r_t = sigmoid(W_r x_t)                  (recurrence gate, block-diagonal)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill run the recurrence through the RG-LRU scan wrapper
(:func:`repro_torch.kernels.rglru_scan.ops.lru`: the CUDA kernel on the
card, differentiated by the adjoint scan on the same kernel; its plain
version on the CPU; the reference computes the same
function with ``jax.lax.associative_scan``); decode is a single
recurrence step carrying h.  The block wraps the LRU with the Griffin
recurrent-block structure: linear in, short depthwise conv, gated output
(tanh GELU, as ``jax.nn.gelu``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.models import sharding
from repro_torch.models.layers import cast, row_parallel
from repro_torch.models.schema import Leaf

RG_LRU_C = 8.0


def rglru_schema(cfg: ModelConfig):
    d = cfg.d_model
    lru = d                                  # lru width == d_model (RG-2B)
    hn = max(cfg.lru_heads, 1)
    bs = lru // hn
    return {
        "wx": Leaf((d, lru), ("embed", "lru")),
        "wgate": Leaf((d, lru), ("embed", "lru")),
        "conv_w": Leaf((cfg.conv_width, lru), ("conv", "lru"), init="fan_in"),
        "conv_b": Leaf((lru,), ("lru",), init="zeros"),
        "gate_i_w": Leaf((hn, bs, bs), ("lru", None, None), fan_axis=1),
        "gate_i_b": Leaf((hn, bs), ("lru", None), init="zeros"),
        "gate_r_w": Leaf((hn, bs, bs), ("lru", None, None), fan_axis=1),
        "gate_r_b": Leaf((hn, bs), ("lru", None), init="zeros"),
        "lam": Leaf((lru,), ("lru",), init="normal"),
        "wo": Leaf((lru, d), ("lru", "embed")),
    }


def _block_diag(x, w, b):
    """x: [B, S, lru], w: [Hn, bs, bs] -> [B, S, lru]."""
    bsz, s, lru = x.shape
    hn, blk, _ = w.shape
    xh = x.reshape(bsz, s, hn, blk)
    y = torch.einsum("bshi,hij->bshj", xh, w) + b
    return y.reshape(bsz, s, lru)


def _gates(params, xb, ctx=None):
    """-> (log_a, gated_input) both [B, S, lru] f32 (under 'model' ranks
    the rank's channels).  Where the rank's channels cut a gate head (its
    gate weights are then replicated), the heads it touches read their
    inputs from ``xb`` gathered over 'model'."""
    wi, bi = cast(params["gate_i_w"]), cast(params["gate_i_b"])
    wr, br = cast(params["gate_r_w"]), cast(params["gate_r_b"])
    n = xb.shape[-1]
    hn, bs = wi.shape[0], wi.shape[1]
    if hn * bs == n:
        xh = xb
        pick = lambda y: y
    else:
        c0 = ctx.tp_index() * n
        ha, hb = c0 // bs, (c0 + n - 1) // bs + 1
        xh = sharding.gather_tp(xb, ctx, -1, summed=True)[
            ..., ha * bs:hb * bs]
        wi, bi, wr, br = (sharding.enter_tp(t, ctx)[ha:hb]
                          for t in (wi, bi, wr, br))
        pick = lambda y: y[..., c0 - ha * bs:c0 - ha * bs + n]
    i = torch.sigmoid(pick(_block_diag(xh, wi, bi)).float())
    r = torch.sigmoid(pick(_block_diag(xh, wr, br)).float())
    log_a = -RG_LRU_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * xb.float())
    return log_a, gated


def _conv1d(x, w, b, state=None):
    """Causal depthwise conv, width W.  x: [B, S, C]; w: [W, C].

    state: [B, W-1, C] carried inputs for decode; returns (y, new_state).
    """
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    new_state = xp[:, xp.shape[1] - (width - 1):, :]
    return y + b, new_state


def rglru_block(params, x, cfg: ModelConfig, state: Tuple = None,
                decode: bool = False, ctx=None):
    """Griffin recurrent block.  x: [B, S, d].

    state: (h [B, lru] f32, conv [B, W-1, lru]) when decoding.
    Returns (out [B, S, d], new_state).

    Under 'model' ranks (the ``"lru"`` channels split) the rank computes
    its channels: ``wx``, ``wgate``, the conv and ``lam`` are its blocks,
    ``wo`` is row-parallel, and the states in and out are the rank's
    channels of the replicated ones (:func:`whole_state` gathers them).
    """
    tp = sharding.tp_split(cfg.d_model, ctx, "lru")
    if tp:
        x = sharding.enter_tp(x, ctx)
        if state is not None:
            state = tuple(sharding.own_block(t, ctx, -1) for t in state)
    xb = torch.matmul(x, cast(params["wx"]))
    gate = torch.matmul(x, cast(params["wgate"]))

    conv_state = state[1] if state is not None else None
    xb, new_conv = _conv1d(xb, cast(params["conv_w"]), cast(params["conv_b"]),
                           conv_state)

    log_a, gated = _gates(params, xb, ctx if tp else None)
    if decode:
        h_prev = state[0]                            # [B, lru] f32
        h = torch.exp(log_a[:, 0]) * h_prev + gated[:, 0]
        hs = h[:, None, :]
        new_h = h
    else:
        hs = lru_ops.lru(log_a, gated)               # [B, S, lru]
        new_h = hs[:, -1]
    out = F.gelu(gate, approximate="tanh") * hs.to(x.dtype)
    if tp:
        out = row_parallel(out, params["wo"], ctx)
    else:
        out = torch.matmul(out, cast(params["wo"]))
    return out, (new_h, new_conv)


def whole_state(state, cfg: ModelConfig, ctx):
    """The replicated decode state from the ranks' channels (gathered over
    'model': the same bits on every rank; no graph)."""
    if not sharding.tp_split(cfg.d_model, ctx, "lru"):
        return state
    return tuple(sharding.all_gather(t, ctx, ctx.tp_axis, t.ndim - 1)
                 for t in state)


def init_state(cfg: ModelConfig, batch: int, device):
    lru = cfg.d_model
    return (torch.zeros((batch, lru), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.conv_width - 1, lru),
                        dtype=torch.float32, device=device))
