"""Model configuration schema for every assigned architecture (a copy of
:mod:`repro.configs.base`).  ``scan_layers`` and ``remat`` describe the
reference's layer stacking; the port keeps one parameter dict per layer
whatever they say."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # attention
    attention: str = "full"        # full | local | none
    window: int = 0                # local-attention window
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp_gated: bool = True         # SwiGLU vs plain GELU MLP

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_groups: int = 1
    conv_width: int = 4

    # hybrid (RecurrentGemma): repeating block pattern
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_heads: int = 0                    # block-diagonal gate heads

    # encoder-decoder
    encoder_layers: int = 0
    is_encdec: bool = False

    # modality frontend (stub): precomputed embeddings are the input
    frontend: str = "none"         # none | audio | vision
    frontend_tokens: int = 0       # prefix length contributed by frontend

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scan_layers: bool = True       # reference: stacked homogeneous layers
    remat: bool = True
    sub_quadratic: bool = False    # supports the long_500k shape

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    # -- derived sizes --------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a TP-friendly multiple (256) so the
        embedding/unembedding tables and logits shard over the model axis
        regardless of tokenizer size; padded logit columns are masked to
        -inf (§Perf hillclimb: unpadded vocabs replicate the CE chain)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind ('attn' | 'rec' | 'ssm' | 'moe')."""
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        if self.is_moe:
            return ("moe",) * self.num_layers
        return ("attn",) * self.num_layers

    def homogeneous(self) -> bool:
        kinds = self.layer_kinds()
        return all(k == kinds[0] for k in kinds)

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6 N D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        counts = {"attn": 0, "moe": 0, "rec": 0, "ssm": 0}
        for kind in self.layer_kinds():
            counts[kind] += 1
        h, k, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn_p = d * (h + 2 * k) * hd + h * hd * d
        mlp_p = d * f * (3 if self.mlp_gated else 2)
        counts_total = 0
        counts_total += counts["attn"] * (attn_p + mlp_p + 2 * d)
        if counts["moe"]:
            e = self.num_experts
            moe_mlp = e * d * f * (3 if self.mlp_gated else 2) + d * e
            counts_total += counts["moe"] * (attn_p + moe_mlp + 2 * d)
        if counts["rec"]:
            lru = d  # lru width == d_model
            blk = lru * lru // max(self.lru_heads, 1)
            rec_p = 2 * d * lru + lru * d + 2 * blk + 3 * lru + lru * self.conv_width
            counts_total += counts["rec"] * (rec_p + mlp_p + 2 * d)
        if counts["ssm"]:
            di, st, g, nh = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
            in_p = d * (2 * di + 2 * g * st + nh)
            ssm_p = in_p + di * d + (di + 2 * g * st) * self.conv_width + 3 * nh + di
            counts_total += counts["ssm"] * (ssm_p + 2 * d)
        enc = 0
        if self.is_encdec:
            # encoder stack + decoder cross-attention
            enc = self.encoder_layers * (attn_p + mlp_p + 2 * d)
            enc += self.num_layers * (attn_p + d)       # cross attn + norm
        return emb + counts_total + enc + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        d, f, e = self.d_model, self.d_ff, self.num_experts
        moe_layers = sum(1 for kk in self.layer_kinds() if kk == "moe")
        expert_p = d * f * (3 if self.mlp_gated else 2)
        inactive = moe_layers * (e - self.experts_per_token) * expert_p
        return full - inactive

    # -- reduced config for CPU smoke tests -----------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config: 2-3 layers, small widths, small vocab."""
        n_layers = len(self.block_pattern) if self.block_pattern else 2
        n_layers = max(n_layers, 2)
        kv = min(self.num_kv_heads, 2)
        heads = max(4, kv * 2)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            window=min(self.window, 32) if self.window else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.experts_per_token else 0),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=8 if self.ssm_state else self.ssm_chunk,
            lru_heads=min(self.lru_heads, 2) if self.lru_heads else 0,
            encoder_layers=2 if self.is_encdec else 0,
            frontend_tokens=(8 if self.frontend != "none" else 0),
        )
