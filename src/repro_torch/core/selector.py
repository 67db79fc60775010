"""Best-approach selection — the paper's conclusion, automated (port of
:mod:`repro.core.selector`).

Given a traffic mix, rank the catalog of memory systems on bandwidth /
power / latency under optional constraints.  :func:`system_mask` is the
static per-system admissibility core that the axes-first
:meth:`repro_torch.core.space.SpaceResult.feasible` mask builds on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.memsys import (
    MemorySystem, default_catalog_items, run_catalog_program,
)
from repro_torch.core.traffic import TrafficMix


@dataclasses.dataclass(frozen=True)
class SelectionConstraints:
    shoreline_mm: float = 8.0              # available die edge for memory I/O
    packaging: Optional[str] = None        # "UCIe-A" | "UCIe-S" | None (any)
    max_power_w: Optional[float] = None
    max_relative_bit_cost: Optional[float] = None
    required_bandwidth_gbs: Optional[float] = None
    #: queue-depth budget: exclude flit-simulated protocols whose
    #: efficiency knee needs a deeper request backlog than this
    max_backlog_knee: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RankedSystem:
    key: str
    name: str
    bandwidth_gbs: float
    pj_per_bit: float
    power_w: float
    latency_ns: float
    relative_bit_cost: float
    gbs_per_watt: float


_OBJECTIVES = ("bandwidth", "power", "gbs_per_watt", "latency")

#: catalog approach prefix -> flit-simulator family key.  A2 shares
#: approach A's lane-group simulator; bus baselines have no entry.
CATALOG_SIM_KEYS = {
    "A:lpddr6-asym": "lpddr6_asym",
    "A2:lpddr6-native": "lpddr6_asym",
    "B:hbm-asym": "hbm_asym",
    "C:chi-sym": "chi",
    "D:cxl-mem": "cxl_unopt",
    "E:cxl-mem-opt": "cxl_opt",
}


def sim_key_for(catalog_key: str) -> Optional[str]:
    """Flit-simulator key backing a catalog system key, or ``None`` for
    bus baselines."""
    return CATALOG_SIM_KEYS.get(catalog_key.split("/")[0])


#: flit-simulator key -> canonical catalog approach prefix
SIM_APPROACH_KEYS = {
    "lpddr6_asym": "A:lpddr6-asym",
    "hbm_asym": "B:hbm-asym",
    "chi": "C:chi-sym",
    "cxl_unopt": "D:cxl-mem",
    "cxl_opt": "E:cxl-mem-opt",
}


def approach_key_for(sim_key: str) -> str:
    """Catalog approach prefix for a flit-simulator protocol key."""
    try:
        return SIM_APPROACH_KEYS[sim_key]
    except KeyError:
        raise KeyError(f"no catalog approach backs simulator key "
                       f"{sim_key!r}; choose from "
                       f"{sorted(SIM_APPROACH_KEYS)}") from None


def default_knees(device=None) -> Dict[str, float]:
    """Backlog knees over the canonical mixes (fixed engine)."""
    from repro_torch.core import flitsim
    return flitsim.backlog_knees(device=device)


def system_mask(items, constraints: SelectionConstraints,
                device=None) -> np.ndarray:
    """Per-system admissibility that doesn't depend on the mix point:
    packaging (bus baselines are excluded by a packaging constraint),
    relative bit cost, and the backlog-knee budget (canonical envelope;
    the knee sweep runs on ``device``)."""
    mask = np.ones(len(items), dtype=bool)
    knees = None
    if constraints.max_backlog_knee is not None:
        knees = default_knees(device)
    for i, (key, ms) in enumerate(items):
        if constraints.packaging:
            if ms.phy is None or constraints.packaging not in key:
                mask[i] = False
        if (constraints.max_relative_bit_cost is not None
                and ms.relative_bit_cost > constraints.max_relative_bit_cost):
            mask[i] = False
        if knees is not None:
            sim = sim_key_for(key)
            if sim is not None and knees[sim] > constraints.max_backlog_knee:
                mask[i] = False
    return mask


def rank(mix: TrafficMix,
         constraints: SelectionConstraints = SelectionConstraints(),
         catalog: Optional[Dict[str, MemorySystem]] = None,
         objective: str = "bandwidth", device=None) -> List[RankedSystem]:
    """Rank all memory systems for a traffic mix.

    objective: "bandwidth" | "power" (pJ/b) | "gbs_per_watt" | "latency".
    """
    if objective not in _OBJECTIVES:
        raise KeyError(objective)
    dev = device_mod.resolve(device)
    items = default_catalog_items() if catalog is None \
        else tuple(catalog.items())
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    bw, pjb, pw, _ = (t.cpu().numpy().astype(np.float64) for t in
                      run_catalog_program(items, f32(mix.x), f32(mix.y),
                                          f32(constraints.shoreline_mm)))
    static_ok = system_mask(items, constraints, dev)
    out: List[RankedSystem] = []
    for i, (key, ms) in enumerate(items):
        if not static_ok[i]:
            continue
        if (constraints.max_power_w is not None
                and pw[i] > constraints.max_power_w):
            continue
        if (constraints.required_bandwidth_gbs is not None
                and bw[i] < constraints.required_bandwidth_gbs):
            continue
        out.append(RankedSystem(
            key=key, name=ms.name, bandwidth_gbs=float(bw[i]),
            pj_per_bit=float(pjb[i]), power_w=float(pw[i]),
            latency_ns=ms.latency_ns,
            relative_bit_cost=ms.relative_bit_cost,
            gbs_per_watt=float(bw[i] / pw[i]) if pw[i] > 0 else float("inf"),
        ))
    keyfn = {
        "bandwidth": lambda r: -r.bandwidth_gbs,
        "power": lambda r: r.pj_per_bit,
        "gbs_per_watt": lambda r: -r.gbs_per_watt,
        "latency": lambda r: r.latency_ns,
    }[objective]
    return sorted(out, key=keyfn)


def best(mix: TrafficMix, **kw) -> RankedSystem:
    """The top of :func:`rank` (same keyword arguments)."""
    ranked = rank(mix, **kw)
    if not ranked:
        raise ValueError("no memory system satisfies the constraints")
    return ranked[0]


def _rank_grid_impl(x, y,
                    constraints: SelectionConstraints = SelectionConstraints(),
                    catalog: Optional[Dict[str, MemorySystem]] = None,
                    objective: str = "bandwidth",
                    shoreline_mm=None, device=None) -> np.ndarray:
    """Best-system key per point of a dense mix grid (numpy object
    array; ``"(none)"`` where no system satisfies the constraints)."""
    if objective not in _OBJECTIVES:
        raise KeyError(objective)
    dev = device_mod.resolve(device)
    items = default_catalog_items() if catalog is None \
        else tuple(catalog.items())
    if shoreline_mm is None:
        shoreline_mm = constraints.shoreline_mm
    f32 = lambda v: torch.as_tensor(np.array(v, np.float32), device=dev)
    bw, pjb, pw, gpw = (t.cpu().numpy() for t in run_catalog_program(
        items, f32(x), f32(y), f32(shoreline_mm)))
    lat = np.asarray([ms.latency_ns for _, ms in items], np.float32)
    score = {"bandwidth": -bw, "power": pjb, "gbs_per_watt": -gpw,
             "latency": np.broadcast_to(
                 lat.reshape((len(items),) + (1,) * (bw.ndim - 1)),
                 bw.shape)}[objective]
    valid = np.broadcast_to(
        system_mask(items, constraints, dev).reshape(
            (len(items),) + (1,) * (bw.ndim - 1)), bw.shape)
    if constraints.max_power_w is not None:
        valid = valid & (pw <= constraints.max_power_w)
    if constraints.required_bandwidth_gbs is not None:
        valid = valid & (bw >= constraints.required_bandwidth_gbs)
    masked = np.where(valid, score, np.inf)
    best = np.asarray([k for k, _ in items], dtype=object)[
        np.argmin(masked, axis=0)]
    return np.where(valid.any(axis=0), best, "(none)")
