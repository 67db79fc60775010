"""Public model API: ``build(cfg) -> Model`` with init / prefill / decode
(port of :mod:`repro.models.model`: the dense, hybrid and ssm families)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import schema as schema_mod
from repro_torch.models import transformer as tf_mod

#: families the port runs
FAMILIES = ("dense", "hybrid", "ssm")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- schema / params -----------------------------------------------------
    @property
    def schema(self):
        return tf_mod.model_schema(self.cfg)

    def init(self, gen: torch.Generator):
        """Random parameters drawn from ``gen`` on ``gen``'s device."""
        return schema_mod.init_params(self.schema, gen, gen.device)

    def param_count(self) -> int:
        return schema_mod.param_count(self.schema)

    # -- forwards --------------------------------------------------------------
    def prefill(self, params, tokens, pad_cache_to: Optional[int] = None):
        """tokens [B, S] -> (last-position logits [B, V], caches)."""
        logits, caches = tf_mod.forward(params, tokens, self.cfg,
                                        mode="prefill")
        if pad_cache_to is not None:
            caches = self.pad_caches(caches, pad_cache_to)
        return logits, caches

    def pad_caches(self, caches, target_len: int):
        """Extend full-attention KV caches' seq dim to target_len (for
        decode continuation after prefill).  Ring (local) caches and
        recurrent states are fixed-size and left untouched."""
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
        return {name: ({kk: _p(t) for kk, t in c.items()}
                       if isinstance(c, dict) else c)
                for name, c in caches.items()}

    def decode_step(self, params, tokens, caches, positions):
        """tokens [B,1] int; positions [B,1] int (absolute)."""
        return tf_mod.forward(params, tokens, self.cfg, mode="decode",
                              caches=caches, positions=positions)

    def init_decode_caches(self, batch: int, max_len: int, device):
        return tf_mod.init_decode_caches(self.cfg, batch, max_len, device)


def build(cfg: ModelConfig) -> Model:
    if cfg.family not in FAMILIES or cfg.is_moe or cfg.is_encdec \
            or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (frontend "
            f"{cfg.frontend!r}) is not ported yet; the port runs the "
            f"dense, hybrid and ssm families (ROADMAP.md queue 1 item 4: "
            f"moe, encdec and vision are still to be ported)")
    if "ssm" in cfg.layer_kinds() and cfg.ssm_groups != 1:
        raise NotImplementedError(
            f"{cfg.name}: ssm_groups={cfg.ssm_groups}; the port's Mamba2 "
            f"block takes one B/C group: the reference's one-step decode "
            f"sums B and C over the groups where its prefill gives each "
            f"head its own group (ROADMAP.md, R7), so no grouped result "
            f"can be held against it")
    return Model(cfg)
