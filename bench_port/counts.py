"""The yardstick's arithmetic: the card's peaks, the least work and bytes
of each kernel the benchmark holds to a roofline, and the model FLOPs of a
served token.

The counts do not depend on how a kernel is implemented: causal attention
counts only the key positions each query reads, the SSD scan counts its
recurrence (not the chunked form's, nor 3xTF32's, extra work), and a
kernel's bytes are its inputs read once and its outputs written once.
"""
from __future__ import annotations

from typing import Tuple

#: NVIDIA H100 SXM5 80 GB, dense rates (NVIDIA's data sheet; the port's
#: ``roofline/hw.py`` holds the same two values)
PEAK_BF16 = 989e12        # FLOP/s, bf16 operands on the tensor cores
PEAK_TF32 = 495e12        # FLOP/s, f32 operands on the tensor cores
HBM_BW = 3.35e12          # bytes/s


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time of ``flops`` at ``peak`` and ``nbytes`` at
    :data:`HBM_BW`: the larger of the two."""
    return max(flops / peak, nbytes / HBM_BW)


def flash_attn(s: int, heads: int, kv_heads: int, hd: int) -> Tuple[float,
                                                                  float]:
    """(FLOPs, bytes) of causal self-attention over ``s`` positions, bf16:
    ``QK^T`` and ``PV`` over the ``s(s+1)/2`` (query, key) pairs a causal
    mask keeps; q, k, v read once, the output written once."""
    pairs = s * (s + 1) / 2
    flops = 4.0 * heads * hd * pairs
    nbytes = 2.0 * s * hd * (2 * heads + 2 * kv_heads)
    return flops, nbytes


def flash_attn_bound_s(s, heads, kv_heads, hd) -> float:
    return bound_s(*flash_attn(s, heads, kv_heads, hd), PEAK_BF16)


def ssd_scan(s: int, heads: int, p: int, n: int,
             init_state: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of the SSD recurrence over ``s`` steps, f32: a step
    of a head decays its ``[P, N]`` state (``P N`` multiplies), adds the
    outer product ``dt x B^T`` (``2 P N``) and reads it out against ``C``
    (``2 P N``).  Read once: x ``[S, H, P]``, dt ``[S, H]``, B and C
    ``[S, N]``, ``a_log`` ``[H]`` and the initial state; written once: y
    ``[S, H, P]`` and the final state ``[H, P, N]``."""
    flops = 5.0 * s * heads * p * n
    words = (2 * s * heads * p + s * heads + 2 * s * n + heads
             + heads * p * n * (2 if init_state else 1))
    return flops, 4.0 * words


def ssd_scan_bound_s(s, heads, p, n, init_state=False) -> float:
    return bound_s(*ssd_scan(s, heads, p, n, init_state), PEAK_TF32)


def token_flops(cfg, context: int) -> float:
    """Model FLOPs of one token that reads ``context`` positions (itself
    included), without the LM head: 2 x the matmul parameters it uses
    (attention projections, the router and its top-k experts, the MLP, the
    SSM projections and conv), attention's ``4 x context x H x hd``, and
    the SSD recurrence's ``5 x H x P x N``."""
    d = cfg.d_model
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "moe"):
            h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            total += 2.0 * d * hd * (2 * h + 2 * k)
            total += 4.0 * context * h * hd
            mats = 3 if cfg.mlp_gated else 2
            if kind == "moe":
                total += 2.0 * d * cfg.num_experts
                total += 2.0 * cfg.experts_per_token * mats * d * cfg.d_ff
            else:
                total += 2.0 * mats * d * cfg.d_ff
        elif kind == "ssm":
            di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            g = cfg.ssm_groups
            total += 2.0 * d * (2 * di + 2 * g * n + nh) + 2.0 * di * d
            total += 2.0 * cfg.conv_width * (di + 2 * g * n)
            total += 5.0 * nh * cfg.ssm_head_dim * n
        else:
            raise ValueError(f"no FLOP count for a {kind!r} layer")
    return total


def lm_head_flops(cfg) -> float:
    return 2.0 * cfg.d_model * cfg.vocab_size


def prefill_flops(cfg, s: int) -> float:
    """A prefill of ``s`` tokens: every position's layers, one LM head
    (the engine reads the last position's logits only)."""
    base = token_flops(cfg, 0) * s
    per_context = token_flops(cfg, 1) - token_flops(cfg, 0)
    return base + per_context * s * (s + 1) / 2 + lm_head_flops(cfg)


def decode_flops(cfg, position: int) -> float:
    """A decoded token at absolute ``position`` (it reads ``position + 1``
    positions) with its LM head."""
    return token_flops(cfg, position + 1) + lm_head_flops(cfg)
