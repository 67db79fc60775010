"""Plain PyTorch version of the RG-LRU linear recurrence — port of
:mod:`repro.kernels.rglru_scan.ref`::

    h_t = exp(log_a_t) * h_{t-1} + b_t

It is the plain version of the CUDA kernel in
``repro_torch/csrc/rglru_scan.cu``, which runs the same sequential
recurrence in the same order (one multiply, then one add, each rounded),
so on the card the two agree bit for bit.
"""
from __future__ import annotations

import torch


def check_operands(log_a, b) -> None:
    """Raise ``ValueError`` unless log_a and b are ``[B, S, C]`` of one
    shape."""
    if log_a.ndim != 3 or log_a.shape != b.shape:
        raise ValueError(f"rglru_scan: want log_a, b [B, S, C] of one "
                         f"shape, got {tuple(log_a.shape)}, "
                         f"{tuple(b.shape)}")


def lru_ref(log_a, b, h0=None):
    """log_a, b: [B, S, C] -> h: [B, S, C] f32."""
    bsz, s, c = b.shape
    a = torch.exp(log_a.float())
    bf = b.float()
    h = (torch.zeros((bsz, c), dtype=torch.float32, device=b.device)
         if h0 is None else h0.float())
    out = []
    for t in range(s):
        h = a[:, t] * h + bf[:, t]
        out.append(h)
    # stacked once: autograd differentiates the loop step by step (an
    # in-place row write would copy the whole gradient at every step)
    return torch.stack(out, dim=1) if out else torch.empty(
        (bsz, 0, c), dtype=torch.float32, device=b.device)
