"""Gradient compression with error feedback (port of
:mod:`repro.train.grad_compress`).

int8 per-tensor-scaled quantization: the quantize -> dequantize round trip
that the receiving side of an int8 all-reduce sees, with the residual e
carried in the optimizer-side state and re-added before the next
quantization (1-bit-Adam / EF-SGD family).  Under a mesh each leaf's scale
is its global ``max|x|`` (a MAX all-reduce over the axes it is sharded
on, as GSPMD gives the reference).  :func:`compressed_psum` is the int8
all-reduce across the ranks of a group.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models import sharding
from repro_torch.train.optimizer import tree_map


def _quantize(x: torch.Tensor, amax=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``amax``: the leaf's global ``max|x|`` where ``x`` is a block."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compress_tree(grads, error_state, ctx=None, specs=None):
    """Quantize-dequantize each gradient leaf with error feedback; under a
    mesh (each leaf a rank's block, ``specs`` its spec) with the leaf's
    global scale.

    Returns (decompressed grads, new error state)."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, error_state)

    def deq(cg, spec=None):
        amax = None
        if spec is not None:
            amax = sharding.reduce_over_shards(torch.max(torch.abs(cg)),
                                               spec, ctx, "max")
        return _dequantize(*_quantize(cg, amax))
    if sharding.active(ctx):
        out = sharding.map_specs(deq, corrected, specs)
    else:
        out = tree_map(deq, corrected)
    err = tree_map(lambda cg, dg: cg - dg, corrected, out)
    return out, err


def compression_ratio() -> float:
    """Payload bytes ratio vs fp32 all-reduce (int8 + one fp32 scale)."""
    return 0.25


def compressed_psum(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    """int8 all-reduce of ``x`` over the ranks of mesh axes ``axes`` (the
    reference's ``compressed_psum(x, axis_name)`` inside ``shard_map``):
    quantize locally, take the largest scale, requantize to it, sum the
    int32 payloads, dequantize."""
    _, scale = _quantize(x)
    scale_max = sharding.all_reduce(scale, ctx, axes, "max")
    q = torch.clamp(torch.round(x / scale_max), -127, 127).to(torch.int32)
    return sharding.all_reduce(q, ctx, axes).float() * scale_max
