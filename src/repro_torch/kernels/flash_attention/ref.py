"""Plain PyTorch version of the flash-attention forward (naive full
softmax in f32) — port of :mod:`repro.kernels.flash_attention.ref`.

Layout: q ``[B, K, G, Sq, hd]`` (H = K*G query heads grouped by KV
head), k/v ``[B, K, Skv, hd]``.  It is the plain version of the CUDA
kernel in ``repro_torch/csrc/flash_attention.cu``; the two agree to
rounding (the kernel runs the streaming softmax over key tiles).
"""
from __future__ import annotations

import torch

#: score of a masked position, as in the reference
NEG_INF = -1e30
#: the largest head dimension the CUDA kernels take
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)


def check_operands(q, k, v) -> None:
    """Raise ``ValueError`` unless q ``[B,K,G,Sq,hd]`` and k, v
    ``[B,K,Skv,hd]`` agree in shape and dtype (f32 or bf16)."""
    if q.ndim != 5 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q [B,K,G,Sq,hd] and k, v "
                         f"[B,K,Skv,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, kh, _, _, hd = q.shape
    if k.shape[0] != b or k.shape[1] != kh or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree in B, K or hd")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: operands must all be f32 or "
                         f"all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")


def attention_mask(sq: int, skv: int, causal: bool, window: int,
                   q_offset: int, device) -> torch.Tensor:
    """bool ``[Sq, Skv]`` (True = attend) by absolute positions: query i
    sits at ``i + q_offset``."""
    q_pos = torch.arange(sq, device=device) + q_offset
    kv_pos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q: [B, K, G, Sq, hd]; k, v: [B, K, Skv, hd] -> [B, K, G, Sq, hd]."""
    sq, hd = q.shape[3], q.shape[4]
    skv = k.shape[2]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32,
                                          device=q.device))
    s = torch.einsum("bkgqh,bksh->bkgqs", q.float(), k.float()) * scale
    mask = attention_mask(sq, skv, causal, window, q_offset, q.device)
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=torch.float32,
                                          device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return out.to(q.dtype)
