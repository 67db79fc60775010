"""Public model API: ``build(cfg) -> Model`` with init / loss / prefill /
decode (port of :mod:`repro.models.model`: every family of the registry).

``Model.loss`` is differentiated by autograd: on the CPU through the
kernels' plain versions, on the card through each kernel wrapper's
``torch.autograd.Function`` (the kernel forward; backward by recompute of
the plain attention and chunked SSD forms, and the RG-LRU adjoint scan on
the same kernel), with every layer rematerialized where ``cfg.remat``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import schema as schema_mod
from repro_torch.models import transformer as tf_mod


def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """Mean CE over valid tokens; f32; optional z-loss regularizer.  A
    masked label may be negative (it is read as 0 and weighs nothing)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp(min=0)[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- schema / params -----------------------------------------------------
    @property
    def schema(self):
        if self.cfg.is_encdec:
            return encdec_mod.encdec_schema(self.cfg)
        return tf_mod.model_schema(self.cfg)

    def init(self, gen: torch.Generator):
        """Random parameters drawn from ``gen`` on ``gen``'s device."""
        return schema_mod.init_params(self.schema, gen, gen.device)

    def param_count(self) -> int:
        return schema_mod.param_count(self.schema)

    # -- forwards --------------------------------------------------------------
    def loss(self, params, batch):
        """-> (loss, metrics).  ``batch``: ``tokens`` and ``labels`` [B, S]
        int, and ``patch_embeds`` [B, P, d] (vision) or ``frames`` [B, Se,
        d] (encoder-decoder); labels are aligned with the token positions
        of the logits (a vision model's patch positions are sliced off).
        The loss is next-token CE (labels < 0 masked) plus 0.01 x the moe
        load-balancing loss."""
        cfg = self.cfg
        if cfg.is_encdec:
            logits, aux = encdec_mod.forward_encdec(
                params, batch["tokens"], cfg, mode="train",
                frames=batch["frames"])
        else:
            pe = batch.get("patch_embeds") if cfg.frontend == "vision" \
                else None
            logits, aux = tf_mod.forward(params, batch["tokens"], cfg,
                                         mode="train", patch_embeds=pe)
            if pe is not None:
                logits = logits[:, pe.shape[1]:, :]
        labels = batch["labels"]
        ce = cross_entropy(logits[:, :-1, :], labels[:, 1:],
                           mask=(labels[:, 1:] >= 0))
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, tokens, pad_cache_to: Optional[int] = None, *,
                patch_embeds=None, frames=None):
        """tokens [B, S] -> (last-position logits [B, V], caches).  A vision
        model may take ``patch_embeds`` [B, P, d], prepended to the text;
        an encoder-decoder model needs ``frames`` [B, Se, d] for its
        encoder."""
        cfg = self.cfg
        if patch_embeds is not None and cfg.frontend != "vision":
            raise ValueError(f"{cfg.name}: patch_embeds given to a model "
                             f"with no vision frontend")
        if cfg.is_encdec:
            if frames is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder prefill "
                                 f"needs frames [B, Se, d]")
            logits, caches = encdec_mod.forward_encdec(
                params, tokens, cfg, mode="prefill", frames=frames)
        else:
            if frames is not None:
                raise ValueError(f"{cfg.name}: frames given to a model "
                                 f"with no encoder")
            logits, caches = tf_mod.forward(params, tokens, cfg,
                                            mode="prefill",
                                            patch_embeds=patch_embeds)
        if pad_cache_to is not None:
            caches = self.pad_caches(caches, pad_cache_to)
        return logits, caches

    def pad_caches(self, caches, target_len: int):
        """Extend full-attention KV caches' seq dim to target_len (for
        decode continuation after prefill).  Ring (local) caches,
        recurrent states and cross-attention caches are fixed-size and
        left untouched."""
        if self.cfg.attention == "local":
            return caches

        def _p(t):
            cur = t.shape[1]
            if cur >= target_len:
                return t
            pad = torch.zeros((t.shape[0], target_len - cur)
                              + tuple(t.shape[2:]), dtype=t.dtype,
                              device=t.device)
            return torch.cat([t, pad], dim=1)

        def _kv(c):
            return ({kk: _p(t) for kk, t in c.items()}
                    if isinstance(c, dict) else c)
        if self.cfg.is_encdec:
            return {name: {"self": _kv(c["self"]), "cross": c["cross"]}
                    for name, c in caches.items()}
        return {name: _kv(c) for name, c in caches.items()}

    def decode_step(self, params, tokens, caches, positions):
        """tokens [B,1] int; positions [B,1] int (absolute)."""
        if self.cfg.is_encdec:
            return encdec_mod.forward_encdec(params, tokens, self.cfg,
                                             mode="decode", caches=caches,
                                             positions=positions)
        return tf_mod.forward(params, tokens, self.cfg, mode="decode",
                              caches=caches, positions=positions)

    def init_decode_caches(self, batch: int, max_len: int, device):
        if self.cfg.is_encdec:
            return encdec_mod.init_decode_caches(self.cfg, batch, max_len,
                                                 device)
        return tf_mod.init_decode_caches(self.cfg, batch, max_len, device)


def build(cfg: ModelConfig) -> Model:
    if "ssm" in cfg.layer_kinds() and cfg.ssm_groups != 1:
        raise NotImplementedError(
            f"{cfg.name}: ssm_groups={cfg.ssm_groups}; the port's Mamba2 "
            f"block takes one B/C group: the reference's one-step decode "
            f"sums B and C over the groups where its prefill gives each "
            f"head its own group (ROADMAP.md, R7), so no grouped result "
            f"can be held against it")
    return Model(cfg)
