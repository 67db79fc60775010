"""The assigned input-shape set (seq_len x global_batch) and applicability
(a copy of :mod:`repro.configs.shapes`).

  train_4k     seq_len=4096    global_batch=256   (training;   train_step)
  prefill_32k  seq_len=32768   global_batch=32    (inference;  prefill_step)
  decode_32k   seq_len=32768   global_batch=128   (inference;  decode_step,
                               one new token against a KV cache of seq_len)
  long_500k    seq_len=524288  global_batch=1     (long-context decode; only
                               for sub-quadratic archs: SSM / hybrid)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a shape applies to an architecture; (ok, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k KV decode needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def microbatches_for(cfg: ModelConfig, shape: ShapeSpec,
                     dp_shards: int) -> int:
    """Default gradient-accumulation factor for train shapes.

    Sized so one microbatch's saved activations stay ~O(100 MB)/chip for
    the large dense archs; tuned further in the perf pass.
    """
    if shape.kind != "train":
        return 1
    per_shard = shape.global_batch // dp_shards
    if cfg.d_model >= 8000 or cfg.vocab_size >= 150_000:
        return min(per_shard, 16)
    if cfg.d_model >= 4000:
        return min(per_shard, 8)
    return min(per_shard, 4)
