"""Shared building blocks: RMSNorm, embeddings, MLPs, RoPE (port of
:mod:`repro.models.layers`).

Parameters are stored in f32 and cast to bf16 where they are used, as in
the reference; RMSNorm and RoPE compute in f32, everything else on bf16
operands.  The gated MLP is ``silu(g) * h`` as the reference computes it
(its configs call it GeGLU; the code is SwiGLU), and the plain MLP uses
the tanh GELU, ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import Leaf

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
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


def embed(params, tokens):
    """tokens ``[B, S]`` integer -> ``[B, S, d]`` bf16.  Gathers the rows
    and casts them (the reference casts the whole table, then gathers:
    the same values)."""
    return cast(params["embed"][tokens])


def unembed(params, x, cfg: ModelConfig):
    """x ``[B, S, d]`` bf16 -> logits ``[B, S, padded_vocab]`` bf16, the
    padding columns set to -1e9."""
    if cfg.tie_embeddings:
        w = cast(params["embed"]).T
    else:
        w = cast(params["unembed"])
    logits = torch.matmul(x, w)
    if cfg.padded_vocab != cfg.vocab_size:
        # mask padding columns so softmax/argmax never see them
        vidx = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(vidx < cfg.vocab_size, logits,
                             torch.tensor(-1e9, dtype=logits.dtype,
                                          device=logits.device))
    return logits


# -- MLP ------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    s = {"wi": Leaf((d, f), ("embed", "mlp")),
         "wo": Leaf((f, d), ("mlp", "embed"))}
    if cfg.mlp_gated:
        s["wg"] = Leaf((d, f), ("embed", "mlp"))
    return s


def mlp(params, x, cfg: ModelConfig):
    h = torch.matmul(x, cast(params["wi"]))
    if cfg.mlp_gated:
        g = torch.matmul(x, cast(params["wg"]))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
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
