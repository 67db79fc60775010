"""Gradient compression with error feedback (port of
:mod:`repro.train.grad_compress`).

int8 per-tensor-scaled quantization: the quantize -> dequantize round trip
that the receiving side of an int8 all-reduce sees, with the residual e
carried in the optimizer-side state and re-added before the next
quantization (1-bit-Adam / EF-SGD family).  ``compressed_psum``, the int8
all-reduce across devices, waits for the port's multi-card slice.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.train.optimizer import tree_map


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compress_tree(grads, error_state):
    """Quantize-dequantize each gradient leaf with error feedback.

    Returns (decompressed grads, new error state)."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, error_state)
    deq = tree_map(lambda cg: _dequantize(*_quantize(cg)), corrected)
    err = tree_map(lambda cg, dg: cg - dg, corrected, deq)
    return deq, err


def compression_ratio() -> float:
    """Payload bytes ratio vs fp32 all-reduce (int8 + one fp32 scale)."""
    return 0.25
