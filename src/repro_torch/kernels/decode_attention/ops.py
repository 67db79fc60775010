"""Launch wrapper of decode attention.

A CPU tensor goes to the plain version (:func:`repro_torch.kernels.
decode_attention.ref.decode_attention_ref`); a CUDA tensor goes to the
CUDA kernel (:mod:`repro_torch.kernels.decode_attention.kernel`), or the
wrapper raises — there is no fallback.  :func:`decode_attention` checks
device, dtype, shape, contiguity and alignment and adds one to
:data:`launches` where it launches the kernel.

While spans record (:mod:`repro_torch.runtime.spans`) it counts
``attn.decode_kernel`` (kernel calls) or ``attn.decode_plain`` (plain
calls), and the plain version's f32 copies of both caches as
``copy.kv_upcast`` (:func:`count_upcast`); the kernel reads the caches in
place.

A fake tensor (the dry run, :mod:`repro_torch.roofline.counts`) goes to
the plain version, whose two einsums are what the dry run counts.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.decode_attention import kernel as _k
from repro_torch.kernels.decode_attention.ref import (
    HEAD_DIMS, MAX_GROUP, check_operands, decode_attention_ref,
)
from repro_torch.kernels.flash_attention.ops import softmax_scale
from repro_torch.roofline import counts
from repro_torch.runtime import spans

#: CUDA calls since the last :func:`reset_launches` (three kernels each)
launches: Dict[str, int] = {"decode_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_upcast(k_cache, v_cache) -> None:
    """``copy.kv_upcast``: the bytes read and written by the f32 copies
    of both caches that plain decode attention makes."""
    if spans.on():
        spans.add("copy.kv_upcast", sum(t.numel() * (t.element_size() + 4)
                                        for t in (k_cache, v_cache)))


def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B, 1, K, G, hd]; caches: [B, S, K, hd]; lengths: [B], row b's
    live positions ``0 .. lengths[b] - 1`` (1 to S) -> [B, 1, K, G, hd]."""
    check_operands(q, k_cache, v_cache, lengths)
    devs = {q.device, k_cache.device, v_cache.device, lengths.device}
    if len(devs) != 1:
        raise ValueError(f"decode_attention: operands on several devices "
                         f"{devs}")
    dev = devs.pop()
    if counts.is_fake(q) or dev.type == "cpu":
        spans.add("attn.decode_plain", 1)
        count_upcast(k_cache, v_cache)
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {dev}")
    hd, g = q.shape[-1], q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if g > MAX_GROUP:
        raise ValueError(f"decode_attention: {g} query heads a KV head > "
                         f"{MAX_GROUP}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"decode_attention: lengths must be int32, got "
                         f"{lengths.dtype}")
    ops = (q, k_cache, v_cache, lengths)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("decode_attention: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in ops[:3]):
        raise ValueError("decode_attention: operands must be 16-byte "
                         "aligned")
    out = _k.decode_attention(q, k_cache, v_cache, lengths,
                              scale=softmax_scale(hd))
    launches["decode_attention"] += 1
    spans.add("attn.decode_kernel", 1)
    return out
