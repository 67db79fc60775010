"""Decoder-only LM assembly for the dense, moe, hybrid, ssm and vision
(vlm) families (port of :mod:`repro.models.transformer`).

Every model keeps one parameter dict and one cache per layer
(``blocks["layer_XX"]``), homogeneous ones too: the reference stacks the
layers of a homogeneous model along a leading ``[L, ...]`` axis for
``lax.scan``, and :func:`repro_torch.convert.model_params` unstacks them.

Three modes:
  train   — full forward, no caches, returns logits [B, S, V] and the moe
            blocks' load-balancing loss summed over the layers
  prefill — builds per-layer caches, returns last-position logits + caches
  decode  — one token per sequence against caches (pos may vary per batch)

A vision model's train and prefill forwards may take precomputed patch
embeddings: projected by ``frontend.proj`` and prepended to the text, so
positions run over ``P + S``.  Where ``cfg.remat``, a training forward
rematerializes each layer (``torch.utils.checkpoint``, non-reentrant,
as the reference's ``jax.checkpoint``): only the layer inputs are kept,
and the backward runs each layer's forward again, its kernels included.
An moe layer's recompute takes the expert choices its forward made
(``moe.moe_block``'s ``routing``).

Decode writes the new token's K/V into the attention caches in place (it
saves a copy of every cache per step) and returns the caches.

A forward under a ``ShardingCtx`` (``models.sharding``) takes each rank's
blocks of the parameters and its rows of the batch: the leaves outside
the layers are gathered over 'data' (FSDP) at the start, each layer's
inside the layer (in training inside its rematerialization too, so a
layer's gathered weights live only while it runs), and every layer runs
tensor parallel over 'model' (``attention``, ``layers``, ``moe``,
``rglru``, ``ssm``).  Prefill and decode return every vocab column; their
caches are the rank's blocks (``Model.cache_specs``): a KV cache's
positions split over 'model' and decoded context parallel
(``attention.decode_attend``).  Under ``ctx.sequence_parallel`` the
residual stream between the layers' tensor-parallel regions holds the
rank's ``S / tp`` positions where they divide (``sharding.seq_split``):
each block gathers the positions after its norm and keeps its own of the
region's output (``sharding.enter_region``, ``sharding.leave_region``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import sharding
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    COMPUTE_DTYPE, cast, embed, embedding_schema, mlp, mlp_schema,
    region_norm, rmsnorm_schema, unembed, whole_logits,
)
from repro_torch.models.schema import Leaf
from repro_torch.runtime import spans

MODES = ("train", "prefill", "decode")


# -- schemas -------------------------------------------------------------------

def block_schema(cfg: ModelConfig, kind: str):
    d = cfg.d_model
    s: Dict[str, Any] = {"ln1": rmsnorm_schema(d), "ln2": rmsnorm_schema(d)}
    if kind == "attn":
        s["attn"] = attn.attn_schema(cfg)
        s["mlp"] = mlp_schema(cfg)
    elif kind == "moe":
        s["attn"] = attn.attn_schema(cfg)
        s["moe"] = moe_mod.moe_schema(cfg)
    elif kind == "rec":
        s["rec"] = rglru_mod.rglru_schema(cfg)
        s["mlp"] = mlp_schema(cfg)
    elif kind == "ssm":
        s = {"ln1": rmsnorm_schema(d), "ssm": ssm_mod.ssm_schema(cfg)}
    else:
        raise ValueError(kind)
    return s


def model_schema(cfg: ModelConfig):
    s: Dict[str, Any] = {
        "embedding": embedding_schema(cfg),
        "final_norm": rmsnorm_schema(cfg.d_model),
        "blocks": {f"layer_{i:02d}": block_schema(cfg, k)
                   for i, k in enumerate(cfg.layer_kinds())},
    }
    if cfg.frontend == "vision":
        s["frontend"] = {"proj": Leaf((cfg.d_model, cfg.d_model),
                                      ("embed", "embed_act"))}
    return s


# -- per-block apply -----------------------------------------------------------

def _attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, device):
    length = min(max_len, cfg.window) if cfg.attention == "local" \
        else max_len
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


def _ring_gather(kv, window: int):
    """kv: [B, S, K, hd] -> ring cache [B, W, K, hd]: slot j holds the
    newest position p <= S-1 with p % W == j."""
    s = kv.shape[1]
    if s <= window:
        pad = torch.zeros((kv.shape[0], window - s) + tuple(kv.shape[2:]),
                          dtype=kv.dtype, device=kv.device)
        return torch.cat([kv, pad], dim=1)
    j = torch.arange(window, device=kv.device)
    p = (s - 1) - ((s - 1 - j) % window)
    return kv[:, p]


def attn_block(lp, x, cfg: ModelConfig, *, mode: str, positions,
               cache=None, routing=None, ctx=None, cache_len=None,
               sp: bool = False, layer=None):
    """-> (x, new cache (None in train mode), moe aux loss or None).
    Under a mesh a prefill's cache holds every KV head and, where they
    divide over 'model', the rank's block of the positions (padded first
    to ``cache_len``); decode reads and writes that block.  ``sp``: ``x``
    holds the rank's positions (sequence parallel).  The attention half
    and the MoE or MLP half are the spans ``block.attn`` and
    ``block.moe`` / ``block.mlp``, ``n`` = ``layer``."""
    with spans.span("block.attn", n=layer):
        x, new_cache = _attn_half(lp, x, cfg, mode, positions, cache, ctx,
                                  cache_len, sp)
    if "moe" in lp:
        with spans.span("block.moe", n=layer):
            h2 = region_norm(lp["ln2"], x, cfg, ctx, sp)
            m, aux = moe_mod.moe_block(lp["moe"], h2, cfg, routing, ctx)
            return x + sharding.leave_region(m, ctx, sp), new_cache, aux
    with spans.span("block.mlp", n=layer):
        h2 = region_norm(lp["ln2"], x, cfg, ctx, sp)
        out = sharding.leave_region(mlp(lp["mlp"], h2, cfg, ctx), ctx, sp)
        return x + out, new_cache, None


def _attn_half(lp, x, cfg: ModelConfig, mode: str, positions, cache, ctx,
               cache_len, sp: bool):
    """``attn_block``'s norm through its output projection and residual
    -> (x, new cache)."""
    h = region_norm(lp["ln1"], x, cfg, ctx, sp)
    window = cfg.window if cfg.attention == "local" else 0
    tp = sharding.active(ctx) and ctx.tp_size() > 1

    if mode == "decode":
        if tp:
            q, k, v = attn.decode_qkv(lp["attn"], h, cfg, positions, ctx)
        else:
            q, k, v = attn.qkv_project(lp["attn"], h, cfg,
                                       positions=positions)
        new_cache, o = attn.decode_attend(q, k, v, cache, positions[:, 0],
                                          window, ctx if tp else None)
    else:
        q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions=positions,
                                   ctx=ctx)
        o = attn.attend_prefill(q, k, v, causal=True, window=window,
                                cfg=cfg, ctx=ctx)
        new_cache = None
        if mode == "prefill":
            k, v = (attn.whole_kv(t, cfg, h.shape[1], ctx) for t in (k, v))
            if window > 0:       # a ring: never padded, always decoded
                k, v = _ring_gather(k, window), _ring_gather(v, window)
                cache_len, decodable = None, True
            else:
                decodable = cache_len is not None
            new_cache = {
                "k": attn.cache_positions(k, ctx, cache_len, decodable),
                "v": attn.cache_positions(v, ctx, cache_len, decodable)}

    x = x + sharding.leave_region(attn.out_project(lp["attn"], o, cfg, ctx),
                                  ctx, sp)
    return x, new_cache


def rec_block(lp, x, cfg: ModelConfig, *, mode: str, positions,
              cache=None, ctx=None, cache_len=None, sp: bool = False,
              layer=None):
    with spans.span("block.rec", n=layer):
        h = region_norm(lp["ln1"], x, cfg, ctx, sp)
        o, new_state = rglru_mod.rglru_block(
            lp["rec"], h, cfg, state=cache, decode=(mode == "decode"),
            ctx=ctx)
        if mode != "train":
            new_state = rglru_mod.whole_state(new_state, cfg, ctx)
        x = x + sharding.leave_region(o, ctx, sp)
        h2 = region_norm(lp["ln2"], x, cfg, ctx, sp)
        out = sharding.leave_region(mlp(lp["mlp"], h2, cfg, ctx), ctx, sp)
        return x + out, new_state, None


def ssm_block_apply(lp, x, cfg: ModelConfig, *, mode: str, positions,
                    cache=None, ctx=None, cache_len=None, sp: bool = False,
                    layer=None):
    with spans.span("block.ssm", n=layer):
        h = region_norm(lp["ln1"], x, cfg, ctx, sp)
        o, new_state = ssm_mod.ssm_block(lp["ssm"], h, cfg, state=cache,
                                         decode=(mode == "decode"), ctx=ctx)
        return x + sharding.leave_region(o, ctx, sp), new_state, None


_BLOCK_FNS = {"attn": attn_block, "moe": attn_block, "rec": rec_block,
              "ssm": ssm_block_apply}


def _cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                device):
    if kind in ("attn", "moe"):
        return _attn_cache_init(cfg, batch, max_len, device)
    if kind == "rec":
        return rglru_mod.init_state(cfg, batch, device)
    if kind == "ssm":
        return ssm_mod.init_state(cfg, batch, device)
    raise ValueError(kind)


# -- model forward --------------------------------------------------------------

def _sharded_layer(fn, specs, ctx):
    """``fn(lp, x)`` on the layer's parameters gathered over 'data'."""
    return lambda lp, x: fn(sharding.fsdp(lp, specs, ctx), x)


def forward(params, tokens, cfg: ModelConfig, *, mode: str, caches=None,
            positions=None, patch_embeds=None, ctx=None, cache_len=None):
    """Shared forward.

    train:   tokens [B, S] (a vision model: and optionally patch_embeds
             [B, P, d], prepended) -> (logits [B, P+S, V], aux f32 scalar;
             under a mesh: the rank's rows and vocab columns, its aux)
    prefill: the same inputs -> (last_logits [B, V], caches)
    decode:  tokens [B, 1], positions [B, 1] = current absolute position
             per sequence -> (logits [B, V], caches)

    Under a mesh the inputs are the rank's rows, prefill and decode
    return every vocab column, and the caches are the rank's blocks (a
    prefill's attention caches padded to ``cache_len`` first).
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    specs = None
    if sharding.active(ctx):
        specs = sharding.tree_specs(model_schema(cfg), ctx)
        top = {k: v for k, v in params.items() if k != "blocks"}
        params = dict(sharding.fsdp(top, specs, ctx),
                      blocks=params["blocks"])
    with spans.span("model.embed"):
        x = embed(params["embedding"], tokens, cfg, ctx)
    if patch_embeds is not None and mode != "decode":
        pe = torch.matmul(cast(patch_embeds),
                          cast(params["frontend"]["proj"]))
        x = torch.cat([pe, x], dim=1)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    sp = sharding.seq_split(s, ctx)
    x = sharding.leave_region(x, ctx, sp)
    sharding.note_stream(x)

    if mode == "train":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.layer_kinds()):
            name = f"layer_{i:02d}"
            kw = {"routing": {}} if kind == "moe" else {}
            fn = functools.partial(
                _BLOCK_FNS[kind], cfg=cfg, mode="train", positions=positions,
                ctx=ctx, sp=sp, **kw)
            if specs is not None:
                fn = _sharded_layer(fn, specs["blocks"][name], ctx)
            lp = params["blocks"][name]
            if cfg.remat:
                x, _, a = checkpoint(fn, lp, x, use_reentrant=False)
            else:
                x, _, a = fn(lp, x)
            if a is not None:
                aux = aux + a
        x = region_norm(params["final_norm"], x, cfg, ctx, sp)
        return unembed(params["embedding"], x, cfg, ctx), aux

    new_caches = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        name = f"layer_{i:02d}"
        lp = params["blocks"][name]
        if specs is not None:
            lp = sharding.fsdp(lp, specs["blocks"][name], ctx)
        x, new_caches[name], _ = _BLOCK_FNS[kind](
            lp, x, cfg, mode=mode, positions=positions,
            cache=caches[name] if mode == "decode" else None, ctx=ctx,
            cache_len=cache_len, sp=sp, layer=i)

    with spans.span("model.head"):
        x = region_norm(params["final_norm"], x, cfg, ctx, sp)
        if mode == "prefill":
            x = x[:, -1:, :]
        logits = whole_logits(unembed(params["embedding"], x, cfg, ctx)[:, 0],
                              cfg, ctx)
    return logits, new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zero caches of every layer for ``batch`` sequences of up to
    ``max_len`` positions."""
    return {f"layer_{i:02d}": _cache_init(cfg, k, batch, max_len, device)
            for i, k in enumerate(cfg.layer_kinds())}
