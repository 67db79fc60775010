"""Encoder-decoder transformer, the seamless-m4t family (port of
:mod:`repro.models.encdec`).

The encoder takes precomputed modality frame embeddings (the audio
frontend is a stub, as in the reference) through ``frontend.adapter``;
the decoder is a causal LM with cross attention into the encoder output.
Each stack keeps one parameter dict per layer (``encoder.blocks`` and
``decoder.blocks``, ``layer_XX``); the reference stacks them for
``lax.scan`` and :func:`repro_torch.convert.model_params` unstacks them.

The encoder's self attention (non-causal), the decoder's self attention
(causal) and the train and prefill forwards' cross attention (non-causal,
``St`` queries against ``Se`` keys) run in the flash-attention wrapper.  Decode runs the
plain ``attend_decode`` for both: the self cache grows by one token in
place, the cross cache (``Se`` positions, all valid) is the prefill's.

A training forward (``mode="train"``) returns the full logits and no
caches; where ``cfg.remat`` it rematerializes each encoder and decoder
layer (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.

Caches, one per decoder layer: ``{"self": {"k", "v"}, "cross": {"k",
"v"}}``.

Under a mesh (``ShardingCtx``) a forward takes the data rank's rows and
gathers the FSDP leaves over 'data': those outside the layers at the
start, each layer's inside the layer.  Over 'model' the encoder's and the
decoder's self attention, the cross attention (queries from the decoder,
K/V from the encoder output) and the MLPs run tensor parallel, as a
decoder-only model's layers do; the self and cross caches hold every head
and the rank's block of the positions or frames.  Under
``ctx.sequence_parallel`` each stack's residual stream holds the rank's
positions or frames between the regions, as a decoder-only model's does;
the encoder output is gathered whole for the cross attention.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import sharding
from repro_torch.models.layers import (
    COMPUTE_DTYPE, cast, embed, mlp, mlp_schema, region_norm,
    rmsnorm_schema, unembed, whole_logits,
)
from repro_torch.models.schema import Leaf


def _layers(schema, n: int):
    return {f"layer_{i:02d}": schema for i in range(n)}


def enc_block_schema(cfg: ModelConfig):
    return {"ln1": rmsnorm_schema(cfg.d_model),
            "attn": attn.attn_schema(cfg),
            "ln2": rmsnorm_schema(cfg.d_model),
            "mlp": mlp_schema(cfg)}


def dec_block_schema(cfg: ModelConfig):
    return {"ln1": rmsnorm_schema(cfg.d_model),
            "attn": attn.attn_schema(cfg),
            "lnx": rmsnorm_schema(cfg.d_model),
            "xattn": attn.attn_schema(cfg, cross=True),
            "ln2": rmsnorm_schema(cfg.d_model),
            "mlp": mlp_schema(cfg)}


def encdec_schema(cfg: ModelConfig):
    d = cfg.d_model
    v = cfg.padded_vocab
    return {
        "embedding": {
            "embed": Leaf((v, d), ("vocab", "embed"), init="normal"),
            "unembed": Leaf((d, v), ("embed", "vocab")),
        },
        "frontend": {"adapter": Leaf((d, d), ("embed", "embed_act"))},
        "encoder": {"blocks": _layers(enc_block_schema(cfg),
                                      cfg.encoder_layers),
                    "final_norm": rmsnorm_schema(d)},
        "decoder": {"blocks": _layers(dec_block_schema(cfg),
                                      cfg.num_layers)},
        "final_norm": rmsnorm_schema(d),
    }


def _enc_block(lp, x, cfg: ModelConfig, positions, ctx=None,
               sp: bool = False):
    h = region_norm(lp["ln1"], x, cfg, ctx, sp)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions=positions,
                               ctx=ctx)
    o = attn.attend_prefill(q, k, v, causal=False, cfg=cfg, ctx=ctx)
    x = x + sharding.leave_region(attn.out_project(lp["attn"], o, cfg, ctx),
                                  ctx, sp)
    h2 = region_norm(lp["ln2"], x, cfg, ctx, sp)
    return x + sharding.leave_region(mlp(lp["mlp"], h2, cfg, ctx), ctx, sp)


def _layer(fn, remat: bool, *args, specs=None, ctx=None):
    """``fn(*args)`` (``args[0]`` the layer's parameters, gathered over
    'data' under a mesh), rematerialized in the backward where
    ``remat``."""
    if specs is not None:
        inner = fn

        def fn(lp, *rest):
            return inner(sharding.fsdp(lp, specs, ctx), *rest)
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params, frames, cfg: ModelConfig, remat: bool = False,
           specs=None, ctx=None):
    """frames: [B, Se, d] precomputed frontend embeddings -> [B, Se, d]
    (every frame on every 'model' rank; sequence parallel in between)."""
    x = torch.matmul(cast(frames), cast(params["frontend"]["adapter"]))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    sp = sharding.seq_split(x.shape[1], ctx)
    x = sharding.leave_region(x, ctx, sp)
    blocks = params["encoder"]["blocks"]
    fn = functools.partial(_enc_block, cfg=cfg, positions=positions,
                           ctx=ctx, sp=sp)
    for i in range(cfg.encoder_layers):
        name = f"layer_{i:02d}"
        x = _layer(fn, remat, blocks[name], x, ctx=ctx, specs=None
                   if specs is None else specs["encoder"]["blocks"][name])
    return region_norm(params["encoder"]["final_norm"], x, cfg, ctx, sp)


def _dec_block(lp, x, enc, cfg: ModelConfig, *, mode: str, positions,
               cache=None, ctx=None, cache_len=None, sp: bool = False):
    """enc: encoder output [B, Se, d] (train, prefill) or None (decode,
    which reads the cross K/V from ``cache``).  Under 'model' ranks the
    self and cross caches are laid out as a decoder-only model's (every
    head, the rank's block of the positions or frames).  ``sp``: ``x``
    holds the rank's positions (sequence parallel)."""
    tp = sharding.active(ctx) and ctx.tp_size() > 1
    h = region_norm(lp["ln1"], x, cfg, ctx, sp)
    if mode == "decode":
        if tp:
            q, k, v = attn.decode_qkv(lp["attn"], h, cfg, positions, ctx)
        else:
            q, k, v = attn.qkv_project(lp["attn"], h, cfg,
                                       positions=positions)
        self_cache, o = attn.decode_attend(q, k, v, cache["self"],
                                           positions[:, 0], 0,
                                           ctx if tp else None)
    else:
        q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions=positions,
                                   ctx=ctx)
        o = attn.attend_prefill(q, k, v, causal=True, cfg=cfg, ctx=ctx)
        self_cache = {n: attn.cache_positions(
            attn.whole_kv(t, cfg, h.shape[1], ctx), ctx, cache_len,
            cache_len is not None) for n, t in (("k", k), ("v", v))} \
            if mode == "prefill" else None
    x = x + sharding.leave_region(attn.out_project(lp["attn"], o, cfg, ctx),
                                  ctx, sp)

    hx = region_norm(lp["lnx"], x, cfg, ctx, sp)
    xp = lp["xattn"]
    if mode == "decode":
        cross = cache["cross"]
        kh, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        if tp:
            qx = attn.whole_project(hx, xp["wq"], None, cfg.num_heads, ctx)
            valid = torch.ones((x.shape[0], cross["k"].shape[1]),
                               dtype=torch.bool, device=x.device)
        else:
            qx = attn.project(hx, xp["wq"])
        qx = qx.reshape(qx.shape[0], 1, kh, g, cfg.head_dim)
        if tp:
            ox = attn.attend_decode_cp(qx, cross["k"], cross["v"], valid,
                                       ctx)
        else:
            ox = attn.attend_decode(qx, cross["k"], cross["v"],
                                    cache_len=cross["k"].shape[1])
    else:
        qx, ck, cv = attn.qkv_project(xp, hx, cfg, rope_on=False, ctx=ctx,
                                      kv_x=enc)
        ox = attn.attend_prefill(qx, ck, cv, causal=False, cfg=cfg, ctx=ctx)
        cross = {n: attn.cache_positions(
            attn.whole_kv(t, cfg, hx.shape[1], ctx), ctx) for n, t in
            (("k", ck), ("v", cv))} if mode == "prefill" else None
    x = x + sharding.leave_region(attn.out_project(xp, ox, cfg, ctx), ctx,
                                  sp)

    h2 = region_norm(lp["ln2"], x, cfg, ctx, sp)
    return x + sharding.leave_region(mlp(lp["mlp"], h2, cfg, ctx), ctx, sp), \
        {"self": self_cache, "cross": cross}


def forward_encdec(params, tokens, cfg: ModelConfig, *, mode: str,
                   frames=None, caches=None, positions=None, ctx=None,
                   cache_len=None):
    """train: tokens [B, St], frames [B, Se, d] -> (logits [B, St, V], aux
    f32 zero); prefill: the same inputs -> (last logits [B, V], caches);
    decode: tokens [B, 1], caches, positions [B, 1] -> (logits [B, V],
    caches).  Under a mesh as :func:`repro_torch.models.transformer.
    forward`: the rank's rows, every vocab column of an inference
    forward's logits, the rank's cache blocks."""
    specs = None
    if sharding.active(ctx):
        specs = sharding.tree_specs(encdec_schema(cfg), ctx)
        top = {k: v for k, v in params.items()
               if k not in ("encoder", "decoder")}
        params = dict(
            sharding.fsdp(top, specs, ctx),
            encoder=dict(params["encoder"], final_norm=sharding.fsdp(
                params["encoder"]["final_norm"],
                specs["encoder"]["final_norm"], ctx)),
            decoder=params["decoder"])
    x = embed(params["embedding"], tokens, cfg, ctx)
    enc = None
    if mode in ("train", "prefill"):
        remat = cfg.remat and mode == "train"
        enc = encode(params, frames, cfg, remat=remat, specs=specs, ctx=ctx)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    elif mode != "decode":
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', "
                         f"'decode')")
    sp = sharding.seq_split(x.shape[1], ctx)
    x = sharding.leave_region(x, ctx, sp)
    sharding.note_stream(x)
    blocks = params["decoder"]["blocks"]
    bspecs = None if specs is None else specs["decoder"]["blocks"]
    if mode == "train":
        fn = functools.partial(_dec_block, enc=enc, cfg=cfg, mode="train",
                               positions=positions, ctx=ctx, sp=sp)
        for i in range(cfg.num_layers):
            name = f"layer_{i:02d}"
            x = _layer(fn, remat, blocks[name], x, ctx=ctx, specs=None
                       if bspecs is None else bspecs[name])[0]
        x = region_norm(params["final_norm"], x, cfg, ctx, sp)
        return unembed(params["embedding"], x, cfg, ctx), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    new_caches = {}
    for i in range(cfg.num_layers):
        name = f"layer_{i:02d}"
        lp = blocks[name] if bspecs is None else \
            sharding.fsdp(blocks[name], bspecs[name], ctx)
        x, new_caches[name] = _dec_block(
            lp, x, enc, cfg, mode=mode, positions=positions,
            cache=caches[name] if mode == "decode" else None, ctx=ctx,
            cache_len=cache_len, sp=sp)
    x = region_norm(params["final_norm"], x, cfg, ctx, sp)
    if mode == "prefill":
        x = x[:, -1:, :]
    return whole_logits(unembed(params["embedding"], x, cfg, ctx)[:, 0],
                        cfg, ctx), new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zero self and cross caches of ``max_len`` positions per decoder
    layer (the reference's decode-only shapes)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)

    def kv():
        return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}
    return {f"layer_{i:02d}": {"self": kv(), "cross": kv()}
            for i in range(cfg.num_layers)}
