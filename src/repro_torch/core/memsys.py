"""MemorySystem — compose a protocol mapping with a UCIe PHY (or a bus
baseline) into a deployable on-package memory model (port of
:mod:`repro.core.memsys`).

:func:`run_catalog_program` stacks every system's closed-form metrics
into ``[S, ...]`` tensors on the device of its inputs — the analytic
engine the axes-first :class:`repro_torch.core.space.DesignSpace` lowers
onto.  The PHY is an axis, not a key suffix:
:func:`run_catalog_phys_program` / :func:`run_approach_phys_program`
stack (phy x system) pairs into one program, which is what
``axis("phy", [...])`` lowers onto; :func:`perturbed_catalog_items`
stacks (catalog_param x system) pairs, what ``axis("catalog_param",
[...])`` lowers onto.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import latency as latency_mod
from repro_torch.core.protocols import (
    ALL_APPROACHES, BASELINES, MemoryProtocol,
)
from repro_torch.core.protocols.base import _div_const
from repro_torch.core.ucie import UCIE_A_32G_55U, UCIE_S_32G, UCIePhy


@dataclasses.dataclass(frozen=True)
class MemorySystem:
    name: str
    protocol: MemoryProtocol
    phy: Optional[UCIePhy] = None          # None for bus baselines
    latency_ns: float = 3.0
    #: relative $/bit of the DRAM behind the interface (LPDDR=1, HBM=7.5)
    relative_bit_cost: float = 1.0

    def bw_eff(self, x, y):
        return self.protocol.bw_eff(x, y)

    def linear_density(self, x, y):
        return self.protocol.bw_density_linear(x, y, self.phy)

    def areal_density(self, x, y):
        return self.protocol.bw_density_areal(x, y, self.phy)

    def pj_per_bit(self, x, y):
        return self.protocol.power_pj_per_bit(x, y, self.phy)

    def bandwidth_gbs(self, x, y, shoreline_mm):
        """Deliverable cache-line GB/s for a shoreline budget."""
        return self.linear_density(x, y) * shoreline_mm

    def power_w(self, x, y, shoreline_mm):
        """Interconnect power (W) at full utilization of the shoreline."""
        gbs = self.bandwidth_gbs(x, y, shoreline_mm)
        return _div_const(gbs * 8.0 * self.pj_per_bit(x, y), 1000.0)


def standard_catalog() -> Dict[str, MemorySystem]:
    """Every (approach x packaging) the paper evaluates + the baselines."""
    cat: Dict[str, MemorySystem] = {}
    lat = latency_mod.MEASURED_FRONTEND_LATENCY_NS
    for key, proto in ALL_APPROACHES.items():
        for phy, tag in ((UCIE_A_32G_55U, "UCIe-A"), (UCIE_S_32G, "UCIe-S")):
            bit_cost = 7.5 if "hbm" in key else 1.0
            cat[f"{key}/{tag}"] = MemorySystem(
                name=f"{proto.name}/{tag}",
                protocol=proto, phy=phy,
                latency_ns=lat["UCIe-Memory"],
                relative_bit_cost=bit_cost,
            )
    for bname, bus in BASELINES.items():
        cat[bname] = MemorySystem(
            name=bus.name, protocol=bus, phy=None,
            latency_ns=lat.get(bname, 6.0),
            relative_bit_cost=7.5 if "HBM" in bname else 1.0,
        )
    return cat


@functools.lru_cache(maxsize=1)
def default_catalog_items() -> Tuple[Tuple[str, MemorySystem], ...]:
    """The standard catalog as a cached tuple of items."""
    return tuple(standard_catalog().items())


@functools.lru_cache(maxsize=1)
def approach_catalog_items() -> Tuple[Tuple[str, MemorySystem], ...]:
    """Per-approach :class:`MemorySystem` templates WITHOUT a baked PHY —
    the catalog a ``phy`` axis stacks (bus baselines excluded)."""
    lat = latency_mod.MEASURED_FRONTEND_LATENCY_NS
    return tuple(
        (key, MemorySystem(
            name=proto.name, protocol=proto, phy=None,
            latency_ns=lat["UCIe-Memory"],
            relative_bit_cost=7.5 if "hbm" in key else 1.0))
        for key, proto in ALL_APPROACHES.items())


def phy_stacked_items(items: Tuple[Tuple[str, MemorySystem], ...],
                      phys) -> Tuple[Tuple[str, MemorySystem], ...]:
    """Flatten (phy x system) into one stacked catalog, PHY-major, so
    program outputs reshape to ``[F, S, ...]``."""
    return tuple(
        (f"{key}@{phy.name}", dataclasses.replace(ms, phy=phy,
                                                  name=f"{ms.name}/{phy.name}"))
        for phy in phys for key, ms in items)


def perturbed_catalog_items(items: Tuple[Tuple[str, MemorySystem], ...],
                            perturbations
                            ) -> Tuple[Tuple[str, MemorySystem], ...]:
    """Flatten (catalog_param x system) into one stacked catalog: each
    multiplicative ``{field: scale}`` perturbation applied to every
    system's PHY (``UCIePhy.perturbed``); systems without a PHY (bus
    baselines) pass through unperturbed.  Perturbation-major, so program
    outputs reshape to ``[Q, S, ...]``."""
    out = []
    for pert in perturbations:
        for key, ms in items:
            if ms.phy is not None and pert:
                ms = dataclasses.replace(ms, phy=ms.phy.perturbed(pert))
            out.append((key, ms))
    return tuple(out)


def run_catalog_program(items: Tuple[Tuple[str, MemorySystem], ...],
                        x, y, shoreline_mm):
    """Evaluate the stacked catalog on (x, y, shoreline) f32 tensors.

    Returns ``(bandwidth_gbs, pj_per_bit, power_w, gbs_per_watt)``, each
    ``[S, *broadcast(x, y, shoreline)]`` on the inputs' device."""
    systems = [ms for _, ms in items]
    bw = torch.stack([ms.bandwidth_gbs(x, y, shoreline_mm)
                      for ms in systems])
    pjb = torch.stack([ms.pj_per_bit(x, y).expand(bw.shape[1:])
                       for ms in systems])
    pw = _div_const(bw * 8.0 * pjb, 1000.0)        # GB/s * pJ/b -> W
    gpw = torch.where(pw > 0, bw / pw, torch.full_like(pw, float("inf")))
    return bw, pjb, pw, gpw


def run_catalog_phys_program(items: Tuple[Tuple[str, MemorySystem], ...],
                             phys, x, y, shoreline_mm):
    """PHY-stacked :func:`run_catalog_program`: ``items`` are PHY-less
    templates (:func:`approach_catalog_items`); every (phy, system) pair
    runs in one stacked program, reshaped to ``[F, S, *grid]``."""
    phys = tuple(phys)
    flat = phy_stacked_items(tuple(items), phys)
    grids = run_catalog_program(flat, x, y, shoreline_mm)
    lead = (len(phys), len(items))
    return tuple(a.reshape(lead + a.shape[1:]) for a in grids)


def run_approach_phys_program(phys, x, y):
    """PHY-stacked approach-density program on (x, y): returns
    ``(linear, areal, pj_per_bit)``, each ``[F, A, *x.shape]``."""
    protos = tuple(ALL_APPROACHES.values())
    lin = torch.stack([
        torch.stack([p.bw_density_linear(x, y, phy) for p in protos])
        for phy in phys])
    areal = torch.stack([
        torch.stack([p.bw_density_areal(x, y, phy) for p in protos])
        for phy in phys])
    pjb = torch.stack([
        torch.stack([p.power_pj_per_bit(x, y, phy).expand(lin.shape[2:])
                     for p in protos])
        for phy in phys])
    return lin, areal, pjb
