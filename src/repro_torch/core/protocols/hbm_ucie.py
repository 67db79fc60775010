"""Approach B — HBM3/4 protocol mapped on Asymmetric UCIe (port of
:mod:`repro.core.protocols.hbm_ucie`): the 138-lane module, reads over
72 lanes and writes over 36, ``t_xRyW = max(8x, 16y)``, 96 command bits
per access over 24 command lanes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.protocols.base import (
    MemoryProtocol, _as_f32, _div_const,
)


@dataclasses.dataclass(frozen=True)
class HBMOnUCIe(MemoryProtocol):
    name: str = "HBM3/4-on-UCIe(asym)"
    asymmetric: bool = True

    total_lanes: int = 138
    read_lanes: int = 72            # Logic->SoC data
    write_lanes: int = 36           # SoC->Logic data
    wmask_lanes: int = 4
    cmd_lanes: int = 24
    cmd_bits_per_access: int = 96
    access_bits: int = 576          # 512 + ECC/meta, as in Approach A

    def read_ui(self, x):
        return _div_const(_as_f32(x) * self.access_bits, self.read_lanes)

    def write_ui(self, y):
        return _div_const(_as_f32(y) * self.access_bits, self.write_lanes)

    def t_xryw(self, x, y):
        return torch.maximum(self.read_ui(x), self.write_ui(y))

    def bw_eff(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        t = self.t_xryw(x, y)
        return (x + y) * 512.0 / (self.total_lanes * t)

    def p_data(self, x, y):
        x, y = _as_f32(x), _as_f32(y)
        p = self.p_idle
        t = self.t_xryw(x, y)
        w_ui = self.write_ui(y)
        r_ui = self.read_ui(x)
        dq_wmask = self.write_lanes + self.wmask_lanes          # 40
        p_s2m_dq = dq_wmask * (w_ui + (t - w_ui) * p)
        cmd_bits = self.cmd_bits_per_access * (x + y)
        p_s2m_cmd = cmd_bits + (self.cmd_lanes * t - cmd_bits) * p
        cmd_ui = _div_const(cmd_bits, self.cmd_lanes)           # 4(x+y)
        p_s2m_crc = torch.maximum(w_ui, cmd_ui) * (1 - p) + t * p
        m2s_lanes = self.read_lanes + 1                         # 73
        p_m2s = m2s_lanes * (r_ui * (1 - p) + t * p)
        total = p_s2m_dq + p_s2m_cmd + p_s2m_crc + p_m2s
        return 512.0 * (x + y) / total
