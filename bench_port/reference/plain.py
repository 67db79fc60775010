"""Pieces the references share: f32 arithmetic with TF32 off, and the
lower precision of the control.

``matmul(x, w, "f32")`` is a plain f32 product.  ``matmul(x, w, "fp8")``
rounds both operands to float8 e4m3 first, ``x`` with a scale per row and
``w`` with a scale per output column (each slice's largest magnitude
mapped to e4m3's largest, 448), then multiplies in f32: the products of an
fp8 inference path, the precision below the port's bf16.
"""
from __future__ import annotations

import contextlib
import math

import torch

PRECISIONS = ("f32", "fp8")
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """f32 products in full f32: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    x, w = x.float(), w.float()
    if prec == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    elif prec != "f32":
        raise ValueError(f"precision {prec!r} not in {PRECISIONS}")
    return x @ w


def rmsnorm(x, scale, eps: float):
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, positions, theta: float):
    """Rotary embedding of ``x`` [S, heads, hd] at ``positions`` [S]: the
    first and second halves of each head rotated as pairs, frequency
    ``theta ** (-i / (hd / 2))`` for pair ``i``."""
    half = x.shape[-1] // 2
    i = torch.arange(half, dtype=torch.float64, device=x.device)
    freq = torch.exp(-math.log(theta) * i / half).float()
    ang = positions.float()[:, None] * freq[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def logits(x, weights, m, prec: str):
    """The LM head of the last norm's output ``x`` [n, d] over the
    configuration's vocabulary (its padding columns are not the model's)."""
    emb = weights["embedding"]
    w = emb["embed"].T if m.get("tie_embeddings") else emb["unembed"]
    return matmul(x, w[:, :m["vocab_size"]], prec)
