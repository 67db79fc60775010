"""Approach E — CXL.Mem with optimization on Symmetric UCIe (port of
:mod:`repro.core.protocols.cxl_mem_opt`).

    Slots_S2M = (16/15)*4y + max((x+y)   - 4y/15, 0)    (eq 17)
    Slots_M2S = (16/15)*4x + max((x+y)/4 - 4x/15, 0)    (eq 18)
    BW_eff    = 4(x+y) / (2*Slots_max)                  (eq 20)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protocols.base import (
    MemoryProtocol, _as_f32, _div_const,
)


@dataclasses.dataclass(frozen=True)
class CXLMemOptOnUCIe(MemoryProtocol):
    name: str = "CXL.Mem-opt-on-UCIe(sym)"
    asymmetric: bool = False

    g_slots_per_flit: int = 15
    data_slots_per_line: int = 4
    requests_per_hs: float = 1.0
    responses_per_slot: float = 4.0

    def slots_s2m(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        data = self.data_slots_per_line * y                  # 4y
        hdr_need = _div_const(x + y, self.requests_per_hs)
        hs_free = _div_const(data, self.g_slots_per_flit)    # 4y/15
        return (16.0 / 15.0) * data + torch.clamp_min(hdr_need - hs_free,
                                                      0.0)

    def slots_m2s(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        data = self.data_slots_per_line * x                  # 4x
        hdr_need = _div_const(x + y, self.responses_per_slot)
        hs_free = _div_const(data, self.g_slots_per_flit)    # 4x/15
        return (16.0 / 15.0) * data + torch.clamp_min(hdr_need - hs_free,
                                                      0.0)

    def slots_max(self, x, y):
        return torch.maximum(self.slots_s2m(x, y), self.slots_m2s(x, y))

    def bw_eff(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        return 4.0 * (x + y) / (2.0 * self.slots_max(x, y))  # eq (20)

    def p_data(self, x, y):
        """eq (22): like eq (16) but no slot lost to CRC/FEC/Hdr/Credit."""
        x, y = _as_f32(x), _as_f32(y)
        p = self.p_idle
        s2m = self.slots_s2m(x, y)
        m2s = self.slots_m2s(x, y)
        smax = self.slots_max(x, y)
        denom = s2m + m2s + (2.0 * smax - s2m - m2s) * p
        return 4.0 * (x + y) / denom
