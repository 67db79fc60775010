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

A training forward under a ``ShardingCtx`` (``models.sharding``) takes
each rank's blocks of the parameters and its rows of the batch: the
leaves outside the layers are gathered over 'data' (FSDP) at the start,
each layer's inside the layer (inside its rematerialization too, so a
layer's gathered weights live only while it runs), and the dense and moe
layers run tensor parallel over 'model' (``attention``, ``layers``,
``moe``).
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
    COMPUTE_DTYPE, cast, embed, embedding_schema, mlp, mlp_schema, rmsnorm,
    rmsnorm_schema, unembed,
)
from repro_torch.models.schema import Leaf

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
               cache=None, routing=None, ctx=None):
    """-> (x, new cache (None in train mode), moe aux loss or None)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    window = cfg.window if cfg.attention == "local" else 0
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions=positions,
                               ctx=ctx)

    if mode == "decode":
        b = x.shape[0]
        pos = positions[:, 0]                              # [B]
        rows = torch.arange(b, device=x.device)
        kc, vc = cache["k"], cache["v"]
        if window > 0:
            slot = pos % window
            kc[rows, slot] = k[:, 0]
            vc[rows, slot] = v[:, 0]
            j = torch.arange(kc.shape[1], device=x.device)
            valid = (j[None, :] <= pos[:, None]) | \
                (pos[:, None] >= window - 1)
            o = attn.attend_decode(q, kc, vc, valid_mask=valid)
        else:
            kc[rows, pos] = k[:, 0]
            vc[rows, pos] = v[:, 0]
            o = attn.attend_decode(q, kc, vc, cache_len=pos + 1)
        new_cache = {"k": kc, "v": vc}
    else:
        o = attn.attend_prefill(q, k, v, causal=True, window=window,
                                cfg=cfg, ctx=ctx)
        if mode == "train":
            new_cache = None
        elif window > 0:
            new_cache = {"k": _ring_gather(k, window),
                         "v": _ring_gather(v, window)}
        else:
            new_cache = {"k": k, "v": v}

    x = x + attn.out_project(lp["attn"], o, cfg, ctx)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        m, aux = moe_mod.moe_block(lp["moe"], h2, cfg, routing, ctx)
        return x + m, new_cache, aux
    return x + mlp(lp["mlp"], h2, cfg, ctx), new_cache, None


def rec_block(lp, x, cfg: ModelConfig, *, mode: str, positions,
              cache=None):
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    o, new_state = rglru_mod.rglru_block(lp["rec"], h, cfg, state=cache,
                                         decode=(mode == "decode"))
    x = x + o
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], h2, cfg), new_state, None


def ssm_block_apply(lp, x, cfg: ModelConfig, *, mode: str, positions,
                    cache=None):
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    o, new_state = ssm_mod.ssm_block(lp["ssm"], h, cfg, state=cache,
                                     decode=(mode == "decode"))
    return x + o, new_state, None


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
            positions=None, patch_embeds=None, ctx=None):
    """Shared forward.

    train:   tokens [B, S] (a vision model: and optionally patch_embeds
             [B, P, d], prepended) -> (logits [B, P+S, V], aux f32 scalar;
             under a mesh: the rank's rows and vocab columns, its aux)
    prefill: the same inputs -> (last_logits [B, V], caches)
    decode:  tokens [B, 1], positions [B, 1] = current absolute position
             per sequence -> (logits [B, V], caches)
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    specs = None
    if sharding.active(ctx):
        if mode != "train":
            raise NotImplementedError(
                f"mode {mode!r} under a mesh: the port shards training "
                f"only (ROADMAP.md queue 1 item 4)")
        specs = sharding.tree_specs(model_schema(cfg), ctx)
        top = {k: v for k, v in params.items() if k != "blocks"}
        params = dict(sharding.fsdp(top, specs, ctx),
                      blocks=params["blocks"])
    x = embed(params["embedding"], tokens, cfg, ctx)
    if patch_embeds is not None and mode != "decode":
        pe = torch.matmul(cast(patch_embeds),
                          cast(params["frontend"]["proj"]))
        x = torch.cat([pe, x], dim=1)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]

    if mode == "train":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.layer_kinds()):
            name = f"layer_{i:02d}"
            kw = {"routing": {}} if kind == "moe" else {}
            if kind in ("attn", "moe"):
                kw["ctx"] = ctx
            fn = functools.partial(
                _BLOCK_FNS[kind], cfg=cfg, mode="train", positions=positions,
                **kw)
            if specs is not None:
                fn = _sharded_layer(fn, specs["blocks"][name], ctx)
            lp = params["blocks"][name]
            if cfg.remat:
                x, _, a = checkpoint(fn, lp, x, use_reentrant=False)
            else:
                x, _, a = fn(lp, x)
            if a is not None:
                aux = aux + a
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embedding"], x, cfg, ctx), aux

    new_caches = {}
    for i, kind in enumerate(cfg.layer_kinds()):
        name = f"layer_{i:02d}"
        x, new_caches[name], _ = _BLOCK_FNS[kind](
            params["blocks"][name], x, cfg, mode=mode, positions=positions,
            cache=caches[name] if mode == "decode" else None)

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if mode == "prefill":
        x = x[:, -1:, :]
    return unembed(params["embedding"], x, cfg)[:, 0], new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zero caches of every layer for ``batch`` sequences of up to
    ``max_len`` positions."""
    return {f"layer_{i:02d}": _cache_init(cfg, k, batch, max_len, device)
            for i, k in enumerate(cfg.layer_kinds())}
