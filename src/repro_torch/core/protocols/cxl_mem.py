"""Approach D — CXL.Mem on Symmetric UCIe, unoptimized flit (port of
:mod:`repro.core.protocols.cxl_mem`).

    Slots_S2M = x + 5y                      (eq 11)
    Slots_M2S = (x+y)/2 + 4x                (eq 12)
    BW_eff    = (15/16) * 4(x+y) / (2*max)  (eq 14)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protocols.base import (
    MemoryProtocol, _as_f32, _div_const,
)


@dataclasses.dataclass(frozen=True)
class CXLMemOnUCIe(MemoryProtocol):
    name: str = "CXL.Mem-on-UCIe(sym)"
    asymmetric: bool = False

    slot_fraction: float = 15.0 / 16.0   # 1 of 16 slots lost to Hdr/CRC
    data_slots_per_line: int = 4         # 64 B / 16 B
    requests_per_slot: float = 1.0       # 74-bit request
    responses_per_slot: float = 2.0      # 26-bit response

    def slots_s2m(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        return (_div_const(x + y, self.requests_per_slot)
                + self.data_slots_per_line * y)

    def slots_m2s(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        return (_div_const(x + y, self.responses_per_slot)
                + self.data_slots_per_line * x)

    def slots_max(self, x, y):
        return torch.maximum(self.slots_s2m(x, y), self.slots_m2s(x, y))

    def bw_eff(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        return (self.slot_fraction * 4.0 * (x + y)
                / (2.0 * self.slots_max(x, y)))            # eq (14)

    def p_data(self, x, y):
        """eq (16): active slots at full power, idle slot-times at p."""
        x, y = _as_f32(x), _as_f32(y)
        p = self.p_idle
        s2m = self.slots_s2m(x, y)
        m2s = self.slots_m2s(x, y)
        smax = self.slots_max(x, y)
        denom = s2m + m2s + (2.0 * smax - s2m - m2s) * p
        return self.slot_fraction * 4.0 * (x + y) / denom
