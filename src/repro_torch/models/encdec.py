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

Under a mesh with one 'model' rank (``ShardingCtx``) a training forward
takes the data rank's rows and gathers the FSDP leaves over 'data': those
outside the layers at the start, each layer's inside the layer.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import sharding
from repro_torch.models.layers import (
    COMPUTE_DTYPE, cast, embed, mlp, mlp_schema, rmsnorm, rmsnorm_schema,
    unembed,
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


def _enc_block(lp, x, cfg: ModelConfig, positions):
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions=positions)
    o = attn.attend_prefill(q, k, v, causal=False)
    x = x + attn.out_project(lp["attn"], o, cfg)
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], h2, cfg)


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
    """frames: [B, Se, d] precomputed frontend embeddings -> [B, Se, d]."""
    x = torch.matmul(cast(frames), cast(params["frontend"]["adapter"]))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    blocks = params["encoder"]["blocks"]
    fn = functools.partial(_enc_block, cfg=cfg, positions=positions)
    for i in range(cfg.encoder_layers):
        name = f"layer_{i:02d}"
        x = _layer(fn, remat, blocks[name], x, ctx=ctx, specs=None
                   if specs is None else specs["encoder"]["blocks"][name])
    return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def _cross_q(lp, hx, cfg: ModelConfig):
    """Cross-attention queries [B, S, K, G, hd] (no RoPE, no bias)."""
    q = attn.project(hx, lp["xattn"]["wq"])
    k = cfg.num_kv_heads
    return q.reshape(q.shape[0], q.shape[1], k, cfg.num_heads // k,
                     cfg.head_dim)


def _dec_block(lp, x, enc, cfg: ModelConfig, *, mode: str, positions,
               cache=None):
    """enc: encoder output [B, Se, d] (train, prefill) or None (decode,
    which reads the cross K/V from ``cache``)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions=positions)
    if mode == "decode":
        pos = positions[:, 0]
        rows = torch.arange(x.shape[0], device=x.device)
        kc, vc = cache["self"]["k"], cache["self"]["v"]
        kc[rows, pos] = k[:, 0]
        vc[rows, pos] = v[:, 0]
        o = attn.attend_decode(q, kc, vc, cache_len=pos + 1)
        self_cache = {"k": kc, "v": vc}
    else:
        o = attn.attend_prefill(q, k, v, causal=True)
        self_cache = {"k": k, "v": v}
    x = x + attn.out_project(lp["attn"], o, cfg)

    hx = rmsnorm(lp["lnx"], x, cfg.norm_eps)
    qx = _cross_q(lp, hx, cfg)
    if mode == "decode":
        cross = cache["cross"]
        ox = attn.attend_decode(qx, cross["k"], cross["v"],
                                cache_len=cross["k"].shape[1])
    else:
        cross = {"k": attn.project(enc, lp["xattn"]["wk"]),
                 "v": attn.project(enc, lp["xattn"]["wv"])}
        ox = attn.attend_prefill(qx, cross["k"], cross["v"], causal=False)
    x = x + attn.out_project(lp["xattn"], ox, cfg)

    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], h2, cfg), {"self": self_cache,
                                         "cross": cross}


def forward_encdec(params, tokens, cfg: ModelConfig, *, mode: str,
                   frames=None, caches=None, positions=None, ctx=None):
    """train: tokens [B, St], frames [B, Se, d] -> (logits [B, St, V], aux
    f32 zero); prefill: the same inputs -> (last logits [B, V], caches);
    decode: tokens [B, 1], caches, positions [B, 1] -> (logits [B, V],
    caches)."""
    specs = None
    if sharding.active(ctx):
        if mode != "train" or ctx.tp_size() > 1:
            raise NotImplementedError(
                f"{cfg.name}: the port shards an encoder-decoder model's "
                f"training over 'data' only (ROADMAP.md queue 1 item 4)")
        specs = sharding.tree_specs(encdec_schema(cfg), ctx)
        top = {k: v for k, v in params.items()
               if k not in ("encoder", "decoder")}
        params = dict(
            sharding.fsdp(top, specs, ctx),
            encoder=dict(params["encoder"], final_norm=sharding.fsdp(
                params["encoder"]["final_norm"],
                specs["encoder"]["final_norm"], ctx)),
            decoder=params["decoder"])
    x = embed(params["embedding"], tokens)
    enc = None
    if mode in ("train", "prefill"):
        remat = cfg.remat and mode == "train"
        enc = encode(params, frames, cfg, remat=remat, specs=specs, ctx=ctx)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    elif mode != "decode":
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', "
                         f"'decode')")
    if mode == "train":
        fn = functools.partial(_dec_block, enc=enc, cfg=cfg, mode="train",
                               positions=positions)
        for i in range(cfg.num_layers):
            name = f"layer_{i:02d}"
            x = _layer(fn, remat, params["decoder"]["blocks"][name], x,
                       ctx=ctx, specs=None if specs is None
                       else specs["decoder"]["blocks"][name])[0]
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return unembed(params["embedding"], x, cfg), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    new_caches = {}
    for i in range(cfg.num_layers):
        name = f"layer_{i:02d}"
        x, new_caches[name] = _dec_block(
            params["decoder"]["blocks"][name], x, enc, cfg, mode=mode,
            positions=positions,
            cache=caches[name] if mode == "decode" else None)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if mode == "prefill":
        x = x[:, -1:, :]
    return unembed(params["embedding"], x, cfg)[:, 0], new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, device):
    """Zero self and cross caches of ``max_len`` positions per decoder
    layer (the reference's decode-only shapes)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)

    def kv():
        return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}
    return {f"layer_{i:02d}": {"self": kv(), "cross": kv()}
            for i in range(cfg.num_layers)}
