"""Approach C — ARM CHI (C2C) on Symmetric UCIe (port of
:mod:`repro.core.protocols.chi_ucie`).

Format-X 256 B container: twelve 20 B granules; a 64 B line needs 4
granules each carrying 16 B of payload:

    G_S2M = x + 5y ;  G_M2S = (x+y)/2 + 4x
    BW_eff = (15/16) * (4/5) * 4(x+y) / (2*G_max)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protocols.base import (
    MemoryProtocol, _as_f32, _div_const,
)


@dataclasses.dataclass(frozen=True)
class CHIOnUCIe(MemoryProtocol):
    name: str = "CHI-on-UCIe(sym)"
    asymmetric: bool = False

    granules_per_flit: int = 12
    granule_bytes: int = 20
    payload_bytes_per_granule: int = 16
    data_granules_per_line: int = 4
    requests_per_granule: float = 1.0
    responses_per_granule: float = 2.0

    @property
    def capacity_fraction(self) -> float:
        return (self.granules_per_flit * self.granule_bytes) / 256.0

    @property
    def payload_efficiency(self) -> float:
        return self.payload_bytes_per_granule / self.granule_bytes

    def granules_s2m(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        return (_div_const(x + y, self.requests_per_granule)
                + self.data_granules_per_line * y)

    def granules_m2s(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        return (_div_const(x + y, self.responses_per_granule)
                + self.data_granules_per_line * x)

    def granules_max(self, x, y):
        return torch.maximum(self.granules_s2m(x, y),
                             self.granules_m2s(x, y))

    def bw_eff(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        return (self.capacity_fraction * self.payload_efficiency
                * 4.0 * (x + y) / (2.0 * self.granules_max(x, y)))

    def p_data(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        p = self.p_idle
        s2m = self.granules_s2m(x, y)
        m2s = self.granules_m2s(x, y)
        gmax = self.granules_max(x, y)
        denom = s2m + m2s + (2.0 * gmax - s2m - m2s) * p
        return (self.capacity_fraction * self.payload_efficiency
                * 4.0 * (x + y) / denom)
