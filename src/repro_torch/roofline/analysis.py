"""Roofline analysis of a dry-run cell and the workload -> design-space
bridge (port of :mod:`repro.roofline.analysis`).

Three terms per (arch x shape x mesh), per chip, in seconds:

    compute    = FLOPs / peak_FLOP/s
    memory     = (read + write bytes) / HBM_bw
    collective = collective_bytes / link_bw

The reference takes the counts from the compiled HLO (a loop-weighted
parse, and XLA's output fraction to split reads from writes); the port
takes them from :mod:`repro_torch.roofline.counts`, which counts rank 0's
program under fake tensors with the same FLOP and fusion rules and counts
reads and writes apart.  The bridge: byte counts -> xRyW traffic mix ->
each UCIe-Memory approach's delivered bandwidth and interconnect energy
for this workload.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.roofline.hw import H100, ChipSpec

#: filename of the aggregate design-space report (bridge + frontiers),
#: written next to the per-cell dry-run artifacts; every per-cell glob
#: skips it
DESIGN_SPACE_JSON = "design_space.json"

#: top-level keys every per-cell dry-run artifact carries
CELL_ARTIFACT_KEYS = ("arch", "shape", "mesh", "roofline")

#: design-space dimensions per-cell consumers do not understand: an
#: artifact declaring them (in an ``axes`` list or mapping) is an aggregate
#: export of the axes-first API, not a workload cell
NON_CELL_AXES = ("phy", "catalog_param")


def is_cell_artifact(d) -> bool:
    """True when a decoded dry-run JSON is a per-cell workload artifact
    (not the ``design_space.json`` report or an axes-first export)."""
    if not isinstance(d, dict):
        return False
    if not all(k in d for k in CELL_ARTIFACT_KEYS):
        return False
    axes = d.get("axes") or ()
    return not any(a in axes for a in NON_CELL_AXES)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float                     # 6 N D (active N for MoE)
    useful_flops_ratio: float              # model_flops / global HLO flops
    read_bytes_per_chip: float = 0.0
    write_bytes_per_chip: float = 0.0
    peak_memory_bytes: float = 0.0
    notes: str = ""

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze(arch: str, shape_name: str, mesh_desc: str, chips: int,
            counts: Dict[str, float], model_flops: float,
            chip: ChipSpec = H100, peak_memory_bytes: float = 0.0,
            notes: str = "") -> RooflineReport:
    """The roofline of one cell from per-chip ``counts``: ``flops``,
    ``read_bytes``, ``write_bytes`` and ``collective_bytes`` (the
    reference's :func:`analyze` with the counts in place of its HLO)."""
    flops = float(counts["flops"])
    read_bytes = float(counts["read_bytes"])
    out_bytes = float(counts["write_bytes"])
    bytes_total = read_bytes + out_bytes
    coll_bytes = float(counts["collective_bytes"])

    compute_s = flops / chip.peak_bf16_flops
    memory_s = bytes_total / chip.hbm_bandwidth
    collective_s = coll_bytes / chip.ici_link_bandwidth
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    global_flops = flops * chips
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_desc, chips=chips,
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=bytes_total,
        collective_bytes_per_chip=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_flops_ratio=(model_flops / global_flops
                            if global_flops else 0.0),
        read_bytes_per_chip=read_bytes, write_bytes_per_chip=out_bytes,
        peak_memory_bytes=peak_memory_bytes, notes=notes)


def _systems_dict(report: RooflineReport, keys, bw_gbs, pj,
                  latency_ns) -> Dict[str, Any]:
    """Per-system bridge metrics from stacked ``[S]`` catalog columns."""
    out: Dict[str, Any] = {}
    for i, key in enumerate(keys):
        bw = float(bw_gbs[i]) * 1e9
        p = float(pj[i])
        out[key] = {
            "bandwidth_gbs": bw / 1e9,
            "pj_per_bit": p,
            "memory_term_s": (report.hlo_bytes_per_chip / bw
                              if bw > 0 else float("inf")),
            "interconnect_energy_j_per_step":
                report.hlo_bytes_per_chip * 8.0 * p * 1e-12,
            "latency_ns": float(latency_ns[i]),
        }
    return out


def memsys_bridge(report: RooflineReport, shoreline_mm: float = 8.0,
                  chip: ChipSpec = H100, device=None) -> Dict[str, Any]:
    """The paper bridge: this workload's traffic mix under every memory
    system of the catalog -> memory-term seconds and interconnect energy,
    the whole catalog in one stacked program on ``device`` (default
    ``"cuda"``)."""
    from repro_torch import device as device_mod
    from repro_torch.core.memsys import default_catalog_items, \
        run_catalog_program
    from repro_torch.core.traffic import TrafficMix
    dev = device_mod.resolve(device)
    mix = TrafficMix.from_bytes(report.read_bytes_per_chip,
                                report.write_bytes_per_chip)
    items = default_catalog_items()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    bw, pjb, _, _ = run_catalog_program(items, f32(mix.x), f32(mix.y),
                                        f32(shoreline_mm))
    lat = [ms.latency_ns for _, ms in items]
    return {"mix": mix.name,
            "read_fraction": mix.read_fraction,
            "hbm_baseline_memory_s": report.memory_s,
            "systems": _systems_dict(
                report, [k for k, _ in items], bw.cpu().numpy(),
                pjb.cpu().numpy(),
                torch.tensor(lat, dtype=torch.float32).numpy())}


def bridge_design_space(reports: Dict[str, RooflineReport],
                        n_fracs: int = 41,
                        shorelines=(2.0, 4.0, 8.0, 16.0),
                        constraints=None,
                        objective: str = "bandwidth",
                        sim=None, device=None) -> Dict[str, Any]:
    """Per-workload design-space frontier over ``[configs x catalog x
    mix-grid x shoreline]`` in one evaluation on ``device``.

    Axes: ``workload_config`` (one mix per named report), ``mix`` whose
    first entry is :data:`~repro_torch.core.space.OWN_MIX` followed by
    the dense read-fraction grid, and ``shoreline_mm``.  Each workload
    reports its per-system metrics and winner at its own mix, its
    read-fraction crossovers and its winner per shoreline budget, all
    under the feasibility mask of ``constraints``."""
    from repro_torch.core import space as space_mod
    from repro_torch.core.selector import SelectionConstraints
    from repro_torch.core.traffic import TrafficMix, mix_grid
    if constraints is None:
        constraints = SelectionConstraints()
    names = list(reports)
    mixes = [TrafficMix.from_bytes(reports[n].read_bytes_per_chip,
                                   reports[n].write_bytes_per_chip)
             for n in names]
    gx, gy = (t.cpu().numpy().astype(np.float64)
              for t in mix_grid(n_fracs, device="cpu"))
    sl = np.asarray(shorelines, dtype=np.float64)
    # the reference budget is always evaluated exactly — appended to the
    # axis if the caller's list doesn't contain it
    if not np.any(np.abs(sl - constraints.shoreline_mm) < 1e-9):
        sl = np.sort(np.append(sl, constraints.shoreline_mm))
    l_ref = int(np.argmin(np.abs(sl - constraints.shoreline_mm)))

    space = space_mod.DesignSpace(space_mod.AxisSet(
        space_mod.axis("workload_config", list(zip(names, mixes))),
        space_mod.axis("mix",
                       [space_mod.OWN_MIX] + list(zip(gx, gy))),
        space_mod.axis("shoreline_mm", sl),
    ), sim=sim, device=device)
    res = space.evaluate(metrics=space_mod.ANALYTIC_METRICS
                         + space_mod.SYSTEM_METRICS)
    feas = res.feasible(constraints)
    metric, mode = {
        "bandwidth": ("bandwidth_gbs", "max"),
        "power": ("pj_per_bit", "min"),
        "gbs_per_watt": ("gbs_per_watt", "max"),
        "latency": ("latency_ns", "min"),
    }[objective]
    best_keys = res.frontier(metric, "system", mode, where=feas).values
    keys = res["bandwidth_gbs"].coord("system")
    bw = res["bandwidth_gbs"].values                    # [S, C, M+1, L]
    pj = res["pj_per_bit"].values
    lat = res["latency_ns"].values
    fracs = gx / 100.0

    out: Dict[str, Any] = {
        "read_fractions": fracs.tolist(),
        "shorelines": sl.tolist(),
        "reference_shoreline_mm": float(sl[l_ref]),
        "objective": objective,
        "keys": list(keys),
        "workloads": {},
    }
    for c, name in enumerate(names):
        rep = reports[name]
        crossovers = [
            {"read_fraction_lo": lo, "read_fraction_hi": hi,
             "best": str(label)}
            for lo, hi, label in space_mod.regimes(
                best_keys[c, 1:, l_ref].tolist(), fracs)]
        sl_frontier = {f"{s:g}mm": str(best_keys[c, 0, l])
                       for l, s in enumerate(sl)}
        out["workloads"][name] = {
            "mix": mixes[c].name,
            "read_fraction": mixes[c].read_fraction,
            "hbm_baseline_memory_s": rep.memory_s,
            "best": str(best_keys[c, 0, l_ref]),
            "feasible": best_keys[c, 0, l_ref] != "(none)",
            "systems": _systems_dict(rep, keys, bw[:, c, 0, l_ref],
                                     pj[:, c, 0, l_ref], lat),
            "crossovers": crossovers,
            "shoreline_frontier": sl_frontier,
            "shoreline_sensitive": len(set(sl_frontier.values())) > 1,
        }
    return out
