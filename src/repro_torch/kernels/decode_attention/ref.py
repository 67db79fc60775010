"""Plain PyTorch version of decode attention: one new token's query heads
against a KV cache, full softmax in f32 over the live positions.

It computes what the reference's ``attend_decode``
(``repro/models/attention.py``) computes: scores in f32 from the bf16
operands, times ``1/sqrt(f32(hd))``, masked positions at -1e30, softmax in
f32, the normalised weights rounded to the operands' dtype, the weighted
sum of V in f32, the output in the operands' dtype.  It is the plain
version of the CUDA kernel in ``repro_torch/csrc/decode_attention.cu``;
the two agree to the order of the f32 sums.

Layout: q ``[B, 1, K, G, hd]`` (H = K*G query heads grouped by KV head),
caches ``[B, S, K, hd]``; ``lengths`` ``[B]``: row b attends over the
positions ``0 .. lengths[b] - 1``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import softmax_scale
from repro_torch.kernels.flash_attention.ref import NEG_INF

#: head dims the CUDA kernel takes (a thread owns 8 elements of a row and
#: a row's threads lie in one warp)
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
#: the most query heads a KV head the CUDA kernel takes
MAX_GROUP = 16
DTYPES = (torch.float32, torch.bfloat16)


def check_operands(q, k_cache, v_cache, lengths) -> None:
    """Raise ``ValueError`` unless q ``[B,1,K,G,hd]``, caches
    ``[B,S,K,hd]`` and ``lengths`` ``[B]`` (integers) agree, and the
    operands are all f32 or all bf16."""
    if q.ndim != 5 or q.shape[1] != 1 or k_cache.ndim != 4 or \
            v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: want q [B,1,K,G,hd] and "
                         f"caches [B,S,K,hd], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, _, kh, _, hd = q.shape
    if k_cache.shape[0] != b or k_cache.shape[2] != kh or \
            k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and the "
                         f"caches {tuple(k_cache.shape)} disagree in B, K "
                         f"or hd")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: operands must all be f32 or "
                         f"all bf16, got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if tuple(lengths.shape) != (b,) or lengths.is_floating_point() or \
            lengths.is_complex() or lengths.dtype == torch.bool:
        raise ValueError(f"decode_attention: want integer lengths [{b}], "
                         f"got {lengths.dtype} {tuple(lengths.shape)}")


def attend_masked(q, k_cache, v_cache, valid_mask):
    """q ``[B,1,K,G,hd]``, caches ``[B,S,K,hd]``, ``valid_mask`` ``[B,S]``
    bool -> ``[B,1,K,G,hd]``.  The scale and the masked score are host
    scalars, so the card is not drained to copy them."""
    logits = torch.einsum("bqkgx,bskx->bqkgs", q.float(),
                          k_cache.float()) * softmax_scale(q.shape[-1])
    logits = torch.where(valid_mask[:, None, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqkgs,bskx->bqkgx", w.to(q.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """:func:`attend_masked` over each row's first ``lengths[b]``
    positions."""
    pos = torch.arange(k_cache.shape[1], device=k_cache.device)
    return attend_masked(q, k_cache, v_cache,
                         pos[None, :] < lengths.reshape(-1, 1))
