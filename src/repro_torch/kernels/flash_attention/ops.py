"""Launch wrapper of the flash-attention forward, and its gradient.

A CPU tensor goes to the plain version (:func:`repro_torch.kernels.
flash_attention.ref.attention_ref`), which autograd differentiates
directly; a CUDA tensor goes to the CUDA kernel
(:mod:`repro_torch.kernels.flash_attention.kernel`), or the wrapper
raises — there is no fallback.  :func:`flash_attention` checks device,
dtype, shape and contiguity and adds one to :data:`launches` where it
launches the kernel.

Gradients: where an operand needs one, the CUDA path runs through
:class:`FlashAttention`, whose forward is the kernel and whose backward
is the reference's (``repro/kernels/flash_attention/ops.py`` ``_bwd``):
the VJP of ``attention_ref`` by recompute from the saved q, k and v.
There is no backward kernel.

A fake tensor (the dry run, :mod:`repro_torch.roofline.counts`) goes to
the operator ``repro_torch::flash_attention_fwd``, whose fake version
gives the output's shape and whose count is the two einsums of the
reference's ``attend_chunked`` over every key chunk it computes; in
training it runs under :class:`FlashAttention` as the kernel does.  Real
tensors never reach the operator.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.roofline import counts
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


class FlashAttention(torch.autograd.Function):
    """``fwd(q, k, v, causal=, window=, q_offset=)`` forward (the kernel on
    the card; a test may pass ``attention_ref``), and the VJP of
    ``attention_ref`` recomputed from the saved operands backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, fwd):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, q_offset)
        return fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        causal, window, q_offset = ctx.mask
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors]
            out = attention_ref(*ins, causal=causal, window=window,
                                q_offset=q_offset)
            dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None, None, None


def _launch(q, k, v, *, causal: bool, window: int, q_offset: int):
    out = _k.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset,
                                 scale=softmax_scale(q.shape[-1]))
    launches["flash_attention_fwd"] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, q_offset: int) -> torch.Tensor:
    return flash_attention(q, k, v, causal, window, q_offset).clone()


@_fwd_op.register_fake
def _(q, k, v, causal, window, q_offset):
    return torch.empty_like(q)


def fwd_flops(q, k, v, *args) -> float:
    """The two einsums of ``attend_chunked`` (scores, then the weighted
    values) over every key position: 4 x B x H x Sq x Skv x hd."""
    b, kh, g, sq, hd = q.shape
    return 4.0 * b * kh * g * sq * k.shape[2] * hd


counts.register_formula("repro_torch::flash_attention_fwd", fwd_flops)


def _traced(q, k, v, *, causal: bool, window: int, q_offset: int):
    return _fwd_op(q, k, v, causal, window, q_offset)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: [B, K, G, Sq, hd]; k, v: [B, K, Skv, hd] -> [B, K, G, Sq, hd]."""
    check_operands(q, k, v)
    if counts.is_fake(q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                        _traced)
        return _traced(q, k, v, causal=causal, window=window,
                       q_offset=q_offset)
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    _launch)
    return _launch(q, k, v, causal=causal, window=window, q_offset=q_offset)
