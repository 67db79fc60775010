"""Traffic-mix abstraction: ``xRyW`` — x reads, y writes of 64 B lines.

Port of :mod:`repro.core.traffic`.  The paper evaluates every approach
over representative read/write mixes (x >= 0, y >= 0, not both 0); data
transferred for xRyW is 512*(x+y) bits.  Every model function accepts
f32 tensors for x and y, so whole mix grids are evaluated in one
vectorized call.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import device as device_mod

CACHE_LINE_BYTES = 64
CACHE_LINE_BITS = 512


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """x reads : y writes (64-byte cache lines)."""

    x: float
    y: float

    def __post_init__(self):
        if self.x < 0 or self.y < 0 or (self.x == 0 and self.y == 0):
            raise ValueError(f"invalid mix x={self.x} y={self.y}")

    @property
    def name(self) -> str:
        return f"{self.x:g}R{self.y:g}W"

    @property
    def read_fraction(self) -> float:
        return self.x / (self.x + self.y)

    @property
    def data_bits(self) -> float:
        return CACHE_LINE_BITS * (self.x + self.y)

    @classmethod
    def from_bytes(cls, read_bytes: float, write_bytes: float) -> "TrafficMix":
        """Bridge from byte counts to the paper's unit (64 B lines),
        normalized so x + y == 100."""
        rx = max(read_bytes, 0.0) / CACHE_LINE_BYTES
        wy = max(write_bytes, 0.0) / CACHE_LINE_BYTES
        tot = rx + wy
        if tot <= 0:
            return cls(1.0, 0.0)
        return cls(100.0 * rx / tot, 100.0 * wy / tot)


# The representative mixes of the Figures 10-12 style sweeps (100%R ...
# 100%W).
PAPER_MIXES: Tuple[TrafficMix, ...] = (
    TrafficMix(1, 0),   # 100% reads
    TrafficMix(4, 1),   # 80/20
    TrafficMix(3, 1),   # 75/25
    TrafficMix(2, 1),   # 67/33 (the paper's canonical "predominant" mix)
    TrafficMix(1, 1),   # 50/50
    TrafficMix(1, 2),   # 33/67
    TrafficMix(1, 3),   # 25/75
    TrafficMix(0, 1),   # 100% writes
)


def mix_grid(n: int = 101, device=None):
    """(x, y) f32 tensors sweeping read fraction 0..1 with x + y = 100,
    so the endpoints are the valid pure-read and pure-write mixes."""
    dev = device_mod.resolve(device)
    r = _linspace01(n, dev)
    x = 100.0 * r
    y = 100.0 - x
    return x, y


def _linspace01(n: int, device) -> torch.Tensor:
    """f32 ``linspace(0, 1, n)`` as the reference computes it: the step
    ``i / (n - 1)`` is a product with the reciprocal of ``n - 1`` and the
    last point is exactly 1."""
    if n < 2:
        return torch.zeros((n,), dtype=torch.float32, device=device)
    r = torch.arange(n - 1, dtype=torch.float32, device=device) \
        * (1.0 / (n - 1))
    return torch.cat([r, torch.ones((1,), dtype=torch.float32,
                                    device=device)])
