"""Existing on-package memory baselines — native LPDDR5/6 and HBM3/4
buses (port of :mod:`repro.core.protocols.baselines`).

Modeled optimistically, exactly as the paper does (§IV.B): no penalty for
bus turn-around, peak data bandwidth for any traffic mix, bump-limited.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protocols.base import MemoryProtocol, _as_f32, _rdiv


@dataclasses.dataclass(frozen=True)
class BidirectionalBusMemory(MemoryProtocol):
    """Optimistic incumbent model: bw_eff == 1, full power while active."""

    name: str = "bus"
    dq_width: int = 0
    data_rate_gtps: float = 0.0
    edge_mm: float = 1.0
    depth_mm: float = 1.0
    pj_per_bit: float = 0.0

    @property
    def peak_bandwidth_gbs(self) -> float:
        return self.dq_width * self.data_rate_gtps / 8.0

    @property
    def linear_density_gbs_mm(self) -> float:
        return self.peak_bandwidth_gbs / self.edge_mm

    @property
    def areal_density_gbs_mm2(self) -> float:
        return self.peak_bandwidth_gbs / (self.edge_mm * self.depth_mm)

    def bw_eff(self, x, y):
        return torch.ones_like(_as_f32(x) + _as_f32(y))

    def p_data(self, x, y):
        return torch.ones_like(_as_f32(x) + _as_f32(y))

    def bw_density_linear(self, x, y, phy=None):
        return self.bw_eff(x, y) * self.linear_density_gbs_mm

    def bw_density_areal(self, x, y, phy=None):
        return self.bw_eff(x, y) * self.areal_density_gbs_mm2

    def power_pj_per_bit(self, x, y, phy=None):
        return _rdiv(self.pj_per_bit, self.p_data(x, y))


LPDDR5 = BidirectionalBusMemory(
    name="LPDDR5(native)", dq_width=128, data_rate_gtps=9.6,
    edge_mm=5.8, depth_mm=1.75, pj_per_bit=2.8,
)

LPDDR6 = BidirectionalBusMemory(
    name="LPDDR6(native)", dq_width=192, data_rate_gtps=12.8,
    # same linear/areal density as LPDDR5, scaled by frequency: the
    # footprint scales with the width ratio
    edge_mm=5.8 * (192 / 128), depth_mm=1.75, pj_per_bit=2.8,
)

HBM3 = BidirectionalBusMemory(
    name="HBM3(native)", dq_width=1024, data_rate_gtps=6.4,
    edge_mm=8.0, depth_mm=2.5, pj_per_bit=0.9,
)

HBM4 = BidirectionalBusMemory(
    name="HBM4(native)", dq_width=2048, data_rate_gtps=6.4,
    edge_mm=8.0, depth_mm=2.5, pj_per_bit=0.9,
)
