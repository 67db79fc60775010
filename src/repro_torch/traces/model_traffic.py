"""First-order memory-traffic model of one decode/prefill step — port of
:mod:`repro.traces.model_traffic`.

:class:`ModelTrafficSpec` reduces a
:class:`repro_torch.configs.ModelConfig` to
the per-token byte flows the serving recorder and the synthetic trace
generator both price:

* KV cache — attention (and MoE-attention) layers write
  ``2 * kv_heads * head_dim`` values per token and read the whole
  per-sequence cache back every decode step (reads grow with context).
* Recurrent state — SSM / recurrent layers read + write a
  context-independent state per token instead.
* MoE expert shuffle — dispatch + combine move each token's activations
  to/from its routed experts (``2 * d_model * experts_per_token``),
  priced half read / half write.
* Weight streaming — active parameters are read once per engine tick
  (amortized across the decode batch), the dominant read flow at small
  batch.

The numbers are first-order by design: the trace axis only consumes the
per-phase *read fraction* and *backlog* these flows imply, not absolute
bandwidth, so layout/replication constants cancel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelTrafficSpec:
    """Per-token byte costs of a model, derived from its config shapes."""

    name: str
    dtype_bytes: int = 2
    #: KV bytes written per generated/prefilled token (all attn layers)
    kv_write_bytes_per_token: float = 0.0
    #: recurrent-state bytes read AND written per token (SSM/rec layers)
    state_bytes_per_token: float = 0.0
    #: MoE dispatch+combine bytes per token (half read, half write)
    moe_shuffle_bytes_per_token: float = 0.0
    #: active parameters streamed (read) once per engine tick
    weight_stream_bytes: float = 0.0

    @classmethod
    def from_config(cls, cfg) -> "ModelTrafficSpec":
        """Price a :class:`repro_torch.configs.ModelConfig` (full or
        reduced)."""
        dtype_bytes = 2
        kinds = list(cfg.layer_kinds())
        n_attn = sum(1 for k in kinds if k in ("attn", "moe"))
        n_moe = sum(1 for k in kinds if k == "moe")
        n_ssm = sum(1 for k in kinds if k == "ssm")
        n_rec = sum(1 for k in kinds if k == "rec")
        kv = (n_attn * 2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes)
        state = 0.0
        if n_ssm:
            state += n_ssm * 2.0 * cfg.d_inner * cfg.ssm_state * dtype_bytes
        if n_rec:
            state += n_rec * 2.0 * cfg.d_model * dtype_bytes
        moe = (2.0 * n_moe * cfg.d_model * cfg.experts_per_token
               * dtype_bytes) if n_moe else 0.0
        return cls(name=cfg.name, dtype_bytes=dtype_bytes,
                   kv_write_bytes_per_token=float(kv),
                   state_bytes_per_token=float(state),
                   moe_shuffle_bytes_per_token=float(moe),
                   weight_stream_bytes=float(cfg.active_param_count()
                                             * dtype_bytes))

    @classmethod
    def from_name(cls, arch_id: str) -> "ModelTrafficSpec":
        """Price a registered architecture by id — config shapes only, no
        model weights (the tier-1 synthetic-trace path)."""
        from repro_torch.configs import get
        return cls.from_config(get(arch_id))

    # -- per-event byte flows (read_bytes, write_bytes) -------------------

    def decode_bytes(self, context_len: int) -> Tuple[float, float]:
        """One decode step of one sequence at ``context_len``: read the
        KV cache back, write one token's KV, cycle the recurrent state,
        shuffle the token through its experts."""
        ctx = max(int(context_len), 0)
        reads = (ctx * self.kv_write_bytes_per_token
                 + self.state_bytes_per_token / 2.0
                 + self.moe_shuffle_bytes_per_token / 2.0)
        writes = (self.kv_write_bytes_per_token
                  + self.state_bytes_per_token / 2.0
                  + self.moe_shuffle_bytes_per_token / 2.0)
        return reads, writes

    def prefill_bytes(self, prompt_len: int) -> Tuple[float, float]:
        """One prompt prefill: fill ``prompt_len`` tokens of KV (the
        write burst the decode stream never shows), read each filled
        entry back once (causal attention over the prompt, flash-style
        single pass), and shuffle every prompt token through the
        experts."""
        n = max(int(prompt_len), 0)
        reads = n * (self.kv_write_bytes_per_token
                     + self.state_bytes_per_token / 2.0
                     + self.moe_shuffle_bytes_per_token / 2.0)
        writes = n * (self.kv_write_bytes_per_token
                      + self.state_bytes_per_token / 2.0
                      + self.moe_shuffle_bytes_per_token / 2.0)
        return reads, writes
