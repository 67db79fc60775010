"""Launch wrapper of the RG-LRU scan.

A CPU tensor goes to the plain version (:func:`repro_torch.kernels.
rglru_scan.ref.lru_ref`); a CUDA tensor goes to the CUDA kernel
(:mod:`repro_torch.kernels.rglru_scan.kernel`), or the wrapper raises —
there is no fallback.  :func:`lru` casts its operands to contiguous f32
(as the reference's wrapper does) and adds one to :data:`launches` where
it launches the kernel; the operands' shapes are checked once, by the CPU
path here or by the kernel's binding.  Any sequence length is taken.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.rglru_scan import kernel as _k
from repro_torch.kernels.rglru_scan.ref import check_operands, lru_ref

#: CUDA launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"rglru_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def lru(log_a, b):
    """log_a, b: [B, S, C] -> h [B, S, C] f32."""
    dev = b.device
    if log_a.device != dev:
        raise ValueError(f"rglru_scan: operands on several devices "
                         f"{log_a.device}, {dev}")
    # converted only where needed: each call is host time on short prompts
    if not (log_a.dtype is torch.float32 and log_a.is_contiguous()):
        log_a = log_a.float().contiguous()
    if not (b.dtype is torch.float32 and b.is_contiguous()):
        b = b.float().contiguous()
    if dev.type == "cpu":
        check_operands(log_a, b)
        return lru_ref(log_a, b)
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {dev}")
    out = _k.rglru_scan(log_a, b)
    launches["rglru_scan"] += 1
    return out
