"""Shared building blocks: RMSNorm, embeddings, MLPs, RoPE (port of
:mod:`repro.models.layers`).

Parameters are stored in f32 and cast to bf16 where they are used, as in
the reference; RMSNorm and RoPE compute in f32, everything else on bf16
operands.  The gated MLP is ``silu(g) * h`` as the reference computes it
(its configs call it GeGLU; the code is SwiGLU), and the plain MLP uses
the tanh GELU, ``jax.nn.gelu``'s default.

Under a ``ShardingCtx`` with 'model' ranks the embedding is a
vocab-parallel lookup, the unembedding gives each rank its vocab columns,
and the MLP is column-parallel in ``wi``/``wg`` and row-parallel in
``wo``; the parameters passed are the rank's 'model' blocks (FSDP already
gathered), and the row-parallel partial products are summed in f32 and
rounded to bf16 once, as one device's product accumulates in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding
from repro_torch.models.schema import Leaf
from repro_torch.runtime import spans

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in bf16; a cast is counted as ``copy.weight_cast`` (bytes
    read and written) while spans record."""
    if x.dtype != COMPUTE_DTYPE and spans.on():
        spans.add("copy.weight_cast", x.numel() * (x.element_size() + 2))
    return x.to(COMPUTE_DTYPE)


# -- RMSNorm ------------------------------------------------------------------

def rmsnorm_schema(d: int):
    return {"scale": Leaf((d,), ("norm",), init="ones")}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# -- Embedding / unembedding --------------------------------------------------

def embedding_schema(cfg: ModelConfig):
    v = cfg.padded_vocab
    s = {"embed": Leaf((v, cfg.d_model), ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        s["unembed"] = Leaf((cfg.d_model, v), ("embed", "vocab"))
    return s


def region_norm(params, x, cfg: ModelConfig, ctx=None, sp: bool = False):
    """A block's norm on the residual stream ``x``, entering its
    tensor-parallel region: under sequence parallelism (``sp``) on the
    rank's positions, which are then gathered
    (:func:`repro_torch.models.sharding.enter_region`), its scale's
    gradient summed over 'model'."""
    return sharding.enter_region(
        rmsnorm(sharding.stream_params(params, ctx, sp), x, cfg.norm_eps),
        ctx, sp)


def vocab_parallel(cfg: ModelConfig, ctx) -> bool:
    """Whether the vocab dimension is split over 'model' (its spec's
    divisibility guard)."""
    return sharding.active(ctx) and ctx.tp_size() > 1 and \
        cfg.padded_vocab % ctx.tp_size() == 0


def embed(params, tokens, cfg: ModelConfig = None, ctx=None):
    """tokens ``[B, S]`` integer -> ``[B, S, d]`` bf16.  Gathers the rows
    and casts them (the reference casts the whole table, then gathers:
    the same values).  Vocab-parallel: each rank looks up the tokens in
    its rows (zeros elsewhere), and the ranks' rows are summed."""
    table = params["embed"]
    if cfg is None or not vocab_parallel(cfg, ctx):
        return cast(table[tokens])
    v0 = ctx.tp_index() * table.shape[0]
    local = tokens - v0
    mine = (local >= 0) & (local < table.shape[0])
    rows = cast(table[torch.where(mine, local, 0)]).float()
    rows = rows * mine[..., None]
    return sharding.leave_tp(rows, ctx).to(COMPUTE_DTYPE)


def unembed(params, x, cfg: ModelConfig, ctx=None):
    """x ``[B, S, d]`` bf16 -> logits ``[B, S, padded_vocab]`` bf16, the
    padding columns set to -1e9; vocab-parallel, this rank's columns."""
    if cfg.tie_embeddings:
        w = cast(params["embed"]).T
    else:
        w = cast(params["unembed"])
    v0 = 0
    if vocab_parallel(cfg, ctx):
        x = sharding.enter_tp(x, ctx)
        v0 = ctx.tp_index() * w.shape[1]
    logits = torch.matmul(x, w)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask padding columns so softmax/argmax never see them
        vidx = v0 + torch.arange(w.shape[1], device=logits.device)
        logits = torch.where(vidx < cfg.vocab_size, logits,
                             torch.tensor(-1e9, dtype=logits.dtype,
                                          device=logits.device))
    return logits


def whole_logits(logits, cfg: ModelConfig, ctx):
    """Every vocab column of an inference forward's logits (vocab-parallel
    ranks' columns gathered over 'model')."""
    if vocab_parallel(cfg, ctx):
        return sharding.gather_tp(logits, ctx, -1)
    return logits


# -- MLP ------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    s = {"wi": Leaf((d, f), ("embed", "mlp")),
         "wo": Leaf((f, d), ("mlp", "embed"))}
    if cfg.mlp_gated:
        s["wg"] = Leaf((d, f), ("embed", "mlp"))
    return s


def row_parallel(h, w, ctx):
    """``h @ w`` of a rank's partial operands summed over 'model' in f32,
    rounded to bf16 once."""
    part = torch.matmul(h.float(), cast(w).float())
    return sharding.leave_tp(part, ctx).to(COMPUTE_DTYPE)


def mlp(params, x, cfg: ModelConfig, ctx=None):
    split = sharding.active(ctx) and ctx.tp_size() > 1 and \
        cfg.d_ff % ctx.tp_size() == 0
    if split:
        x = sharding.enter_tp(x, ctx)
    h = torch.matmul(x, cast(params["wi"]))
    if cfg.mlp_gated:
        g = torch.matmul(x, cast(params["wg"]))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    if split:
        return row_parallel(h, params["wo"], ctx)
    return torch.matmul(h, cast(params["wo"]))


# -- RoPE -----------------------------------------------------------------------

def rope_angles(positions, hd: int, theta: float = 10000.0):
    """positions: [B, S] (use [1, S] to share across batch) ->
    (cos, sin) each [B, S, hd//2] f32."""
    assert positions.ndim == 2, "positions must be [B, S]"
    half = hd // 2
    dev = positions.device
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=dev))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32,
                                                device=dev) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [B, S, <head dims...>, hd]; cos/sin: [B, S, hd//2] or [S, hd//2].

    Head axes are broadcast by inserting singleton dims before the last."""
    half = x.shape[-1] // 2
    while cos.ndim < x.ndim:
        cos = cos.unsqueeze(-2)
        sin = sin.unsqueeze(-2)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
