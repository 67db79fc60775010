"""Launch wrapper of the flash-attention forward.

A CPU tensor goes to the plain version (:func:`repro_torch.kernels.
flash_attention.ref.attention_ref`); a CUDA tensor goes to the CUDA kernel
(:mod:`repro_torch.kernels.flash_attention.kernel`), or the wrapper
raises — there is no fallback.  :func:`flash_attention` checks device,
dtype, shape and contiguity and adds one to :data:`launches` where it
launches the kernel.  Forward only: the port has no training path.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention.ref import (
    MAX_HEAD_DIM, attention_ref, check_operands,
)

#: CUDA launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"flash_attention_fwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def softmax_scale(hd: int) -> float:
    """``1 / sqrt(f32(hd))`` rounded to f32, the reference's scale
    (computed once per head dim: the wrapper's host time counts at short
    prompts)."""
    return float(1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: [B, K, G, Sq, hd]; k, v: [B, K, Skv, hd] -> [B, K, G, Sq, hd]."""
    check_operands(q, k, v)
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"flash_attention: operands on several devices "
                         f"{devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} > "
                         f"{MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: operands must be contiguous")
    out = _k.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset,
                                 scale=softmax_scale(q.shape[-1]))
    launches["flash_attention_fwd"] += 1
    return out
