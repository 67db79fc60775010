"""Attention: GQA with RoPE, causal / local-window / cross (port of
:mod:`repro.models.attention`).

Two execution paths:

  * train and prefill — the flash-attention forward
    (:func:`repro_torch.kernels.flash_attention.ops.flash_attention`) in
    its ``[B, K, G, S, hd]`` layout: the CUDA kernel on the card (in
    training through its ``torch.autograd.Function``), its plain version
    on the CPU.  The reference computes the same function
    with its streaming-softmax oracle ``attend_chunked``.
  * ``attend_decode`` — one new token against a KV cache, plain PyTorch
    (the reference computes it outside any Pallas kernel too).

Layout: q [B, S, K, G, hd] (H = K*G query heads grouped by KV head),
k/v [B, S, K, hd].  GQA never materializes repeated KV.

Tensor parallelism over 'model' (a ``ShardingCtx`` with ``tp > 1``; the
parameters passed are the rank's blocks) takes the reference's branches in
its order (:func:`tp_branch`):

  1. ``"kv_heads"``: KV heads divisible by TP — each rank projects its
     KV heads and their query groups (column-parallel), attends on them
     and sums its part of the output projection (row-parallel);
  2. ``"heads"``: total heads divisible by TP — each rank projects its
     flat query heads; K/V are projected whole (their weights are
     replicated) and each local query head takes its KV head, so the
     rank attends with one query a KV head; the output as in 1;
  3. ``"q_seq"``: otherwise, with the query length divisible by TP —
     q, k and v are projected whole on every rank, each rank attends
     with its ``S / tp`` query rows (``q_offset`` = its first row) against
     all of K/V, and the rows are gathered.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import sharding
from repro_torch.models.layers import apply_rope, cast, rope_angles, \
    row_parallel
from repro_torch.models.schema import Leaf


def attn_schema(cfg: ModelConfig, cross: bool = False):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": Leaf((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Leaf((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Leaf((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Leaf((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = Leaf((h, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = Leaf((k, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = Leaf((k, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def project(x, w):
    """x [B, S, d] bf16, w [d, n, hd] -> [B, S, n, hd] bf16."""
    d, n, hd = w.shape
    return torch.matmul(x, cast(w).reshape(d, n * hd)).reshape(
        x.shape[0], x.shape[1], n, hd)


def tp_branch(cfg: ModelConfig, sq: int, ctx) -> str:
    """The reference's TP layout of attention: ``"kv_heads"``,
    ``"heads"``, ``"q_seq"``, or ``"none"`` (replicated)."""
    tp = ctx.tp_size() if sharding.active(ctx) else 1
    k = cfg.num_kv_heads
    if tp > 1 and k % tp == 0:
        return "kv_heads"
    if tp > 1 and cfg.num_heads % tp == 0 and not ctx.force_seq_attn:
        return "heads"
    if tp > 1 and sq % tp == 0 and sq > 1:
        return "q_seq"
    return "none"


def qkv_project(params, x, cfg: ModelConfig, positions=None,
                rope_on: bool = True, ctx=None):
    """x: [B, S, d] -> q [B,S,K,G,hd], k/v [B,S,K,hd]; under TP this
    rank's heads (``"heads"``: q [B,S,H/tp,1,hd] and each local head's KV
    head, k/v [B,S,H/tp,hd])."""
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // k
    branch = tp_branch(cfg, x.shape[1], ctx)
    xq = sharding.enter_tp(x, ctx) if branch in ("kv_heads", "heads") \
        else x
    q = project(xq, params["wq"])
    kk = project(xq if branch == "kv_heads" else x, params["wk"])
    v = project(xq if branch == "kv_heads" else x, params["wv"])
    if "bq" in params:
        q = q + cast(params["bq"])
        kk = kk + cast(params["bk"])
        v = v + cast(params["bv"])
    if rope_on and positions is not None:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        kk = apply_rope(kk, cos, sin)
    if branch == "heads":
        # K/V whole on every rank: each local flat head takes its KV head
        hl = q.shape[2]
        heads = ctx.tp_index() * hl + torch.arange(hl, device=x.device)
        kk = sharding.enter_tp(kk, ctx)[:, :, heads // g]
        v = sharding.enter_tp(v, ctx)[:, :, heads // g]
        return q.reshape(q.shape[0], q.shape[1], hl, 1, hd), kk, v
    if branch == "q_seq":
        q, kk, v = (sharding.enter_tp(t, ctx) for t in (q, kk, v))
    kl = kk.shape[2]
    return q.reshape(q.shape[0], q.shape[1], kl, q.shape[2] // kl, hd), \
        kk, v


def out_project(params, o, cfg: ModelConfig, ctx=None):
    """o: [B, S, K, G, hd] -> [B, S, d]; under TP this rank's heads'
    part summed over 'model' (row-parallel)."""
    b, s, k, g, hd = o.shape
    w = params["wo"]
    if tp_branch(cfg, s, ctx) in ("kv_heads", "heads"):
        return row_parallel(o.reshape(b, s, k * g * hd),
                            w.reshape(k * g * hd, w.shape[-1]), ctx)
    w = cast(w)
    return torch.matmul(o.reshape(b, s, k * g * hd),
                        w.reshape(k * g * hd, w.shape[-1]))


def attend_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                   cfg: ModelConfig = None, ctx=None):
    """q [B, S, K, G, hd], k/v [B, S, K, hd] -> [B, S, K, G, hd] through
    the flash-attention wrapper (kernel layout ``[B, K, G, S, hd]``).
    Under the ``"q_seq"`` branch each rank attends with its query rows and
    the rows are gathered over 'model'."""
    q_offset = 0
    split = cfg is not None and tp_branch(cfg, q.shape[1], ctx) == "q_seq"
    if split:
        rows = q.shape[1] // ctx.tp_size()
        q_offset = ctx.tp_index() * rows
        q = q[:, q_offset:q_offset + rows]
    o = fa_ops.flash_attention(q.permute(0, 2, 3, 1, 4).contiguous(),
                               k.permute(0, 2, 1, 3).contiguous(),
                               v.permute(0, 2, 1, 3).contiguous(),
                               causal, window, q_offset)
    o = o.permute(0, 3, 1, 2, 4)
    return sharding.gather_tp(o, ctx, 1) if split else o


def attend_decode(q, k_cache, v_cache, cache_len=None, valid_mask=None):
    """One-token attention against a cache.

    q: [B, 1, K, G, hd]; caches: [B, S, K, hd].
    cache_len: int or [B] — number of valid positions (the new token's
    K/V must already be written, i.e. cache_len INCLUDES it); OR
    valid_mask: [B, S] bool (ring buffers / arbitrary validity).
    Scores and the weighted sum accumulate in f32 from the bf16 operands
    (the reference's ``preferred_element_type=float32``).
    """
    hd = q.shape[-1]
    s = k_cache.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32,
                                          device=q.device))
    logits = torch.einsum("bqkgx,bskx->bqkgs", q.float(),
                          k_cache.float()) * scale
    if valid_mask is None:
        pos = torch.arange(s, device=q.device)
        valid_mask = pos[None, :] < torch.as_tensor(
            cache_len, device=q.device).reshape(-1, 1)
    logits = torch.where(valid_mask[:, None, None, None, :], logits,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqkgs,bskx->bqkgx", w.to(q.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)
