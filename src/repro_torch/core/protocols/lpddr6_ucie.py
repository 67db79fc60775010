"""Approach A — LPDDR6 protocol mapped on Asymmetric (Enhanced) UCIe
(port of :mod:`repro.core.protocols.lpddr6_ucie`), eqs (1)-(10) of the
paper for the 74-lane module:

    reads :  576 / 36 lanes = 16 UI each        (eq 1)
    writes:  576 / 24 lanes = 24 UI each        (eq 1)
    t_xRyW = max(16x, 24y)                      (eq 2)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protocols.base import (
    MemoryProtocol, _as_f32, _div_const,
)


@dataclasses.dataclass(frozen=True)
class LPDDR6OnUCIe(MemoryProtocol):
    name: str = "LPDDR6-on-UCIe(asym)"
    asymmetric: bool = True

    total_lanes: int = 74          # counted data lanes, both directions
    read_lanes: int = 36           # Mem->SoC data
    write_lanes: int = 24          # SoC->Mem data
    wmask_lanes: int = 2
    cmd_lanes: int = 10            # 8 CA + 2 CS
    cmd_bits_per_access: int = 96  # eq (6)
    access_bits: int = 576         # 512 data + 64 meta/ECC

    def read_ui(self, x):
        return _div_const(_as_f32(x) * self.access_bits, self.read_lanes)

    def write_ui(self, y):
        return _div_const(_as_f32(y) * self.access_bits, self.write_lanes)

    def t_xryw(self, x, y):
        """eq (2): the link is full duplex."""
        return torch.maximum(self.read_ui(x), self.write_ui(y))

    def bw_eff(self, x, y):
        """eq (3)."""
        x, y = _as_f32(x), _as_f32(y)
        t = self.t_xryw(x, y)
        return (x + y) * 512.0 / (self.total_lanes * t)

    def p_data(self, x, y):
        """eqs (5)-(9)."""
        x, y = _as_f32(x), _as_f32(y)
        p = self.p_idle
        t = self.t_xryw(x, y)
        w_ui = self.write_ui(y)            # 24y
        r_ui = self.read_ui(x)             # 16x
        dq_wmask = self.write_lanes + self.wmask_lanes        # 26
        p_s2m_dq = dq_wmask * (w_ui + (t - w_ui) * p)          # eq (5)
        cmd_bits = self.cmd_bits_per_access * (x + y)
        p_s2m_cmd = cmd_bits + (self.cmd_lanes * t - cmd_bits) * p  # (6)
        cmd_ui = _div_const(cmd_bits, self.cmd_lanes)         # 9.6(x+y)
        p_s2m_crc = torch.maximum(w_ui, cmd_ui) * (1 - p) + t * p   # (7)
        m2s_lanes = self.read_lanes + 1                       # 37
        p_m2s = m2s_lanes * (r_ui * (1 - p) + t * p)           # eq (8)
        total = p_s2m_dq + p_s2m_cmd + p_s2m_crc + p_m2s
        return 512.0 * (x + y) / total                        # eq (9)


@dataclasses.dataclass(frozen=True)
class LPDDR6NativeUCIe(LPDDR6OnUCIe):
    """Fig 4b variant: LPDDR6 die with native UCIe PHY (single module,
    43-45 data lanes optimized 2:1 read:write)."""

    name: str = "LPDDR6-native-UCIe(asym)"
    total_lanes: int = 43
    read_lanes: int = 24
    write_lanes: int = 12
    wmask_lanes: int = 1
    cmd_lanes: int = 4
    cmd_bits_per_access: int = 48
