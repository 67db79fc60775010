"""Protocol-mapping interface shared by approaches A-E and the bus
baselines (port of :mod:`repro.core.protocols.base`).

Every protocol model is a pair of pure functions over the traffic mix
(x reads : y writes of 64 B lines), on f32 tensors:

  * ``bw_eff(x, y)`` — fraction of the PHY's raw bandwidth that carries
    cache-line data;
  * ``p_data(x, y)`` — data-power ratio, idle lane groups burning
    ``p`` (= 0.15) of peak power.

Derived: bandwidth density = bw_eff * PHY density; realizable pJ/b =
PHY pJ/b / p_data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.ucie import IDLE_POWER_FRACTION, UCIePhy


@dataclasses.dataclass(frozen=True)
class MemoryProtocol:
    """Base class; subclasses override ``bw_eff`` and ``p_data``."""

    name: str = "base"
    #: idle-lane power fraction (paper: p = 0.15)
    p_idle: float = IDLE_POWER_FRACTION
    #: True when each direction has independently-sized lane groups
    #: (asymmetric UCIe); informational — the math lives in each subclass
    asymmetric: bool = False

    def bw_eff(self, x, y):
        raise NotImplementedError

    def p_data(self, x, y):
        raise NotImplementedError

    def bw_density_linear(self, x, y, phy: UCIePhy):
        """GB/s per mm of die shoreline for mix xRyW."""
        return self.bw_eff(x, y) * phy.linear_density_gbs_mm

    def bw_density_areal(self, x, y, phy: UCIePhy):
        """GB/s per mm^2 for mix xRyW."""
        return self.bw_eff(x, y) * phy.areal_density_gbs_mm2

    def power_pj_per_bit(self, x, y, phy: UCIePhy):
        """Realizable pJ per data bit for mix xRyW (eq 10 / 17 / 23)."""
        return _rdiv(phy.power_pj_per_bit, self.p_data(x, y))

    def effective_bandwidth_gbs(self, x, y, phy: UCIePhy,
                                shoreline_mm: Optional[float] = None):
        """Deliverable data GB/s for a given shoreline budget (or one
        block)."""
        if shoreline_mm is None:
            return self.bw_eff(x, y) * phy.raw_bandwidth_gbs
        return self.bw_density_linear(x, y, phy) * shoreline_mm


def _as_f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.as_tensor(v, dtype=torch.float32)


def _div_const(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` for a Python constant ``c``, computed as ``t * (1/c)``:
    the reference's compiler turns a division by a constant into that
    product, and PyTorch's CUDA division by a host scalar does the same,
    so the CPU and the card agree bit for bit."""
    return t * (1.0 / c)


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` for a Python constant ``c``, as a correctly rounded
    division (``Tensor.__rtruediv__`` multiplies by a reciprocal)."""
    return torch.full_like(t, c) / t
