"""Attention: GQA with RoPE, causal / local-window / cross (port of
:mod:`repro.models.attention`).

Two execution paths:

  * train and prefill — the flash-attention forward
    (:func:`repro_torch.kernels.flash_attention.ops.flash_attention`) in
    its ``[B, K, G, S, hd]`` layout: the CUDA kernel on the card (in
    training through its ``torch.autograd.Function``), its plain version
    on the CPU.  The reference computes the same function
    with its streaming-softmax oracle ``attend_chunked``.
  * decode — one new token against a KV cache (:func:`decode_attend`):
    the decode-attention wrapper
    (:func:`repro_torch.kernels.decode_attention.ops.decode_attention`)
    over each row's live prefix of the cache, the CUDA kernel on the card
    (which reads the bf16 caches in place), its plain version on the CPU.
    The reference computes it outside any Pallas kernel.  The context-
    parallel decode, the enc-dec cross attention (an arbitrary mask) and
    direct callers take the plain ``attend_decode``.

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

The same branches serve cross attention (K/V projected from the encoder
output, ``qkv_project(..., kv_x=)``).  A prefill's caches hold every KV
head (:func:`whole_kv`) and the rank's block of the positions
(:func:`cache_positions`).  Decode under 'model' ranks is context
parallel (:func:`decode_attend`): every rank projects the new token's q,
k and v with all heads (:func:`decode_qkv`), writes k and v where it
holds the position, attends over its positions and merges the partial
softmaxes by log-sum-exp (:func:`attend_decode_cp`); ``wo`` stays
row-parallel by heads.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import attend_masked
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import sharding
from repro_torch.models.layers import apply_rope, cast, rope_angles, \
    row_parallel
from repro_torch.models.schema import Leaf
from repro_torch.runtime import spans


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
                rope_on: bool = True, ctx=None, kv_x=None):
    """x: [B, S, d] -> q [B,S,K,G,hd], k/v [B,Skv,K,hd], K/V projected
    from ``kv_x`` [B, Skv, d] where given (cross attention), else from
    ``x``.  Under TP this rank's heads: ``"kv_heads"``, its KV heads and
    their groups; ``"heads"``, q [B,S,H/tp,1,hd] and K/V whole
    (:func:`attend_prefill` gives each local head its KV head)."""
    hd = cfg.head_dim
    branch = tp_branch(cfg, x.shape[1], ctx)
    src = x if kv_x is None else kv_x
    xq = sharding.enter_tp(x, ctx) if branch in ("kv_heads", "heads") \
        else x
    xkv = sharding.enter_tp(src, ctx) if branch == "kv_heads" else src
    q = project(xq, params["wq"])
    kk = project(xkv, params["wk"])
    v = project(xkv, params["wv"])
    if "bq" in params:
        q = q + cast(params["bq"])
        kk = kk + cast(params["bk"])
        v = v + cast(params["bv"])
    if rope_on and positions is not None:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        kk = apply_rope(kk, cos, sin)
    if branch == "heads":
        kk, v = sharding.enter_tp(kk, ctx), sharding.enter_tp(v, ctx)
        return q.reshape(q.shape[0], q.shape[1], q.shape[2], 1, hd), kk, v
    if branch == "q_seq":
        q, kk, v = (sharding.enter_tp(t, ctx) for t in (q, kk, v))
    kl = kk.shape[2]
    return q.reshape(q.shape[0], q.shape[1], kl, q.shape[2] // kl, hd), \
        kk, v


def whole_kv(t, cfg: ModelConfig, sq: int, ctx):
    """A prefill's K or V [B, Skv, K?, hd] with every KV head: the
    ``"kv_heads"`` branch's heads gathered over 'model' (no graph)."""
    if tp_branch(cfg, sq, ctx) == "kv_heads":
        return sharding.all_gather(t, ctx, ctx.tp_axis, 2)
    return t


def out_project(params, o, cfg: ModelConfig, ctx=None):
    """o: [B, S, K, G, hd] -> [B, S, d].  Where ``wo`` is the rank's
    block of heads, its heads' part summed over 'model' (row-parallel);
    ``o`` holds either those heads or all of them (decode)."""
    b, s = o.shape[:2]
    hd = cfg.head_dim
    w = params["wo"]
    hl = w.shape[0]
    flat = o.reshape(b, s, -1, hd)
    if hl == cfg.num_heads:
        return torch.matmul(flat.reshape(b, s, hl * hd),
                            cast(w).reshape(hl * hd, w.shape[-1]))
    if flat.shape[2] != hl:
        flat = sharding.own_block(sharding.enter_tp(flat, ctx), ctx, 2)
    return row_parallel(flat.reshape(b, s, hl * hd),
                        w.reshape(hl * hd, w.shape[-1]), ctx)


def attend_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                   cfg: ModelConfig = None, ctx=None):
    """q [B, S, K, G, hd], k/v [B, Skv, K, hd] -> [B, S, K, G, hd] through
    the flash-attention wrapper (kernel layout ``[B, K, G, S, hd]``).
    Under the ``"heads"`` branch each local query head takes its KV head;
    under ``"q_seq"`` each rank attends with its query rows (``q_offset``
    its first) and the rows are gathered over 'model'."""
    q_offset = 0
    branch = tp_branch(cfg, q.shape[1], ctx) if cfg is not None else "none"
    if branch == "heads":
        hl = q.shape[2]
        heads = ctx.tp_index() * hl + torch.arange(hl, device=q.device)
        g = cfg.num_heads // cfg.num_kv_heads
        k, v = k[:, :, heads // g], v[:, :, heads // g]
    split = branch == "q_seq"
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


# -- decode under a mesh: every head, the rank's cache positions ----------------

def whole_project(x, w, b, n: int, ctx):
    """``project(x, w)`` (+ bias ``b``) with all ``n`` heads: a ``w``
    that is the rank's block of heads projects them, gathered over
    'model' (no graph)."""
    t = project(x, w)
    if b is not None:
        t = t + cast(b)
    if t.shape[2] != n:
        t = sharding.all_gather(t, ctx, ctx.tp_axis, 2)
    return t


def decode_qkv(params, x, cfg: ModelConfig, positions, ctx):
    """One new token's q [B,1,K,G,hd] and k/v [B,1,K,hd] with every head
    on every rank (:func:`whole_project`), RoPE applied."""
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = whole_project(x, params["wq"], params.get("bq"), h, ctx)
    kk = whole_project(x, params["wk"], params.get("bk"), k, ctx)
    v = whole_project(x, params["wv"], params.get("bv"), k, ctx)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    kk = apply_rope(kk, cos, sin)
    return q.reshape(q.shape[0], 1, k, h // k, hd), kk, v


def attend_decode_cp(q, k_cache, v_cache, valid_mask, ctx):
    """:func:`attend_decode` over the rank's cache positions, the partial
    softmaxes merged over 'model' by log-sum-exp: one all-reduce of the
    maxima, one of the rescaled sums and outputs.  The weights stay f32
    (one device rounds its normalised weights to bf16 before the weighted
    sum; a split softmax has no such point)."""
    hd = q.shape[-1]
    da_ops.count_upcast(k_cache, v_cache)
    logits = torch.einsum("bqkgx,bskx->bqkgs", q.float(),
                          k_cache.float()) / math.sqrt(hd)
    logits = torch.where(valid_mask[:, None, None, None, :], logits,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=q.device))
    m = sharding.all_reduce(logits.amax(dim=-1, keepdim=True), ctx,
                            ctx.tp_axis, "max")
    p = torch.exp(logits - m)
    part = torch.cat([torch.einsum("bqkgs,bskx->bqkgx", p, v_cache.float()),
                      p.sum(dim=-1, keepdim=True)], dim=-1)
    part = sharding.all_reduce(part, ctx, ctx.tp_axis)
    return (part[..., :hd] / part[..., hd:]).to(q.dtype)


def attend_decode(q, k_cache, v_cache, cache_len=None, valid_mask=None):
    """One-token attention against a cache, plain PyTorch.

    q: [B, 1, K, G, hd]; caches: [B, S, K, hd].
    cache_len: int or [B] — number of valid positions (the new token's
    K/V must already be written, i.e. cache_len INCLUDES it); OR
    valid_mask: [B, S] bool (ring buffers / arbitrary validity).
    Scores and the weighted sum accumulate in f32 from the bf16 operands
    (the reference's ``preferred_element_type=float32``).
    """
    if valid_mask is None:
        pos = torch.arange(k_cache.shape[1], device=q.device)
        valid_mask = pos[None, :] < torch.as_tensor(
            cache_len, device=q.device).reshape(-1, 1)
    da_ops.count_upcast(k_cache, v_cache)
    return attend_masked(q, k_cache, v_cache, valid_mask)


def live_lengths(pos, s: int, window: int):
    """[B] int32: how many of a decode cache's ``s`` positions row b
    attends over after writing position ``pos[b]`` — a prefix, by tensor
    ops with no host read: ``pos + 1`` (at most ``s``), and with a ring
    (``window > 0``) all ``s`` once it has wrapped
    (``pos >= window - 1``)."""
    n = torch.clamp(pos + 1, max=s)
    if window > 0:
        n = torch.where(pos >= window - 1, s, n)
    return n.to(torch.int32)


def cache_positions(t, ctx, cache_len=None, decodable: bool = True):
    """A prefill's K or V cache [B, S, K, hd]: padded with zeros to
    ``cache_len``, then, under a mesh, this rank's block of the positions
    where they divide over 'model' (the spec's ``"seq_kv"``).  A cache that is
    to be decoded must divide: the decode step reads a cache under
    'model' ranks as split.  (An unpadded full-attention cache has no
    room for a decoded token, in either package, and keeps the spec's
    layout.)"""
    if cache_len is not None and cache_len > t.shape[1]:
        pad = t.new_zeros((t.shape[0], cache_len - t.shape[1])
                          + tuple(t.shape[2:]))
        t = torch.cat([t, pad], dim=1)
        if spans.on():       # the concatenation's reads and writes
            spans.add("copy.cache_pad", 2 * t.numel() * t.element_size())
    if not sharding.active(ctx) or ctx.tp_size() == 1:
        return t
    if sharding.tp_split(t.shape[1], ctx):
        return sharding.own_block(t, ctx, 1).contiguous()
    if decodable:
        raise ValueError(
            f"a decode cache of {t.shape[1]} positions does not split over "
            f"{ctx.tp_size()} 'model' ranks; the context-parallel decode "
            f"needs a length that divides")
    return t


def decode_attend(q, k, v, cache, pos, window: int, ctx):
    """Write the new token's K/V into the cache (in place; with ``ctx``,
    'model' ranks each holding a block of the positions, on the rank that
    holds its position or ring slot) and attend over the cache: on one
    device over each row's live prefix (:func:`live_lengths`) through the
    decode-attention wrapper, under 'model' ranks by
    :func:`attend_decode_cp`.  -> (cache, o [B, 1, K, G, hd])."""
    kc, vc = cache["k"], cache["v"]
    rows = torch.arange(q.shape[0], device=q.device)
    at = pos % window if window > 0 else pos
    if ctx is None:
        kc[rows, at] = k[:, 0]
        vc[rows, at] = v[:, 0]
        o = da_ops.decode_attention(q.contiguous(), kc, vc,
                                    live_lengths(pos, kc.shape[1], window))
        return {"k": kc, "v": vc}, o
    # under 'model' ranks the cache holds the rank's block of positions
    p0 = ctx.tp_index() * kc.shape[1]
    j = p0 + torch.arange(kc.shape[1], device=q.device)
    if window > 0:
        valid = (j[None, :] <= pos[:, None]) | (pos[:, None] >= window - 1)
    else:
        valid = j[None, :] <= pos[:, None]
    mine = (at >= p0) & (at < p0 + kc.shape[1])
    slot = torch.clamp(at - p0, 0, kc.shape[1] - 1)
    kc[rows, slot] = torch.where(mine[:, None, None], k[:, 0],
                                 kc[rows, slot])
    vc[rows, slot] = torch.where(mine[:, None, None], v[:, 0],
                                 vc[rows, slot])
    o = attend_decode_cp(q, kc, vc, valid, ctx)
    return {"k": kc, "v": vc}, o
