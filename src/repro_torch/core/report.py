"""ONE frontier/report API — port of :mod:`repro.core.report`.

:func:`build_report` resolves a :class:`ReportSpec` into typed
:class:`FrontierReport` sections whose payloads have the schema of the
reference's ``design_space.json`` sections:

* ``"frontier"`` — the calling space's own winner map (materialized, or
  streamed with the ``stream=`` option: ``engine`` ``"streaming"`` and
  ``win_counts``).
* ``"joint"`` — :func:`repro_torch.core.space.joint_frontier`.
* ``"phy"`` — the PHY-stacked analytic frontier (UCIe-A/S, 32G + 48G).
* ``"sim_phy"`` — its cycle-level counterpart (simulated efficiency x raw
  PHY bandwidth, per queue depth).
* ``"serving"`` — the per-(model, QPS) serving-trace winner map.

Every section runs on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

__all__ = ["FrontierReport", "ReportSpec", "build_report"]

#: sections that need no DesignSpace instance (they build their own)
STANDALONE_SECTIONS: Tuple[str, ...] = ("joint", "phy", "sim_phy",
                                        "serving")


@dataclasses.dataclass(frozen=True)
class ReportSpec:
    """What to report: which sections, under which simulation config.

    ``options`` maps section name -> keyword options for that section's
    builder; ``sim`` is the default :class:`~repro_torch.core.space.
    SimConfig` of the simulated sections (a per-section ``sim`` option
    wins); ``verbose`` prints the explorer's progress lines."""

    sections: Tuple[str, ...] = STANDALONE_SECTIONS
    sim: Optional[Any] = None
    options: Mapping[str, Mapping[str, Any]] = dataclasses.field(
        default_factory=dict)
    verbose: bool = False

    def __post_init__(self):
        object.__setattr__(self, "sections",
                           tuple(str(s) for s in self.sections))


@dataclasses.dataclass(frozen=True)
class FrontierReport:
    """One typed report section: the JSON-able payload plus its name."""

    section: str
    payload: Dict[str, Any]

    def __getitem__(self, key: str) -> Any:
        return self.payload[key]

    def __contains__(self, key: str) -> bool:
        return key in self.payload


def build_report(spec: Optional[ReportSpec] = None, *, space=None,
                 device=None) -> Dict[str, FrontierReport]:
    """Resolve ``spec`` into ``{section: FrontierReport}``; ``space`` is
    the :class:`~repro_torch.core.space.DesignSpace` the ``"frontier"``
    section reduces."""
    from repro_torch import device as device_mod
    dev = device_mod.resolve(device)
    spec = spec if spec is not None else ReportSpec()
    builders = {"frontier": _frontier_section, "joint": _joint_section,
                "phy": _phy_section, "sim_phy": _sim_phy_section,
                "serving": _serving_section}
    unknown = [s for s in spec.sections if s not in builders]
    if unknown:
        raise ValueError(f"unknown report sections {unknown}; choose "
                         f"from {sorted(builders)}")
    out: Dict[str, FrontierReport] = {}
    for section in spec.sections:
        if section == "frontier" and space is None:
            raise ValueError(
                "the 'frontier' section reduces a DesignSpace instance; "
                "call space.report(spec) instead of the standalone form")
        opts = dict(spec.options.get(section, {}))
        if section in ("joint", "sim_phy", "frontier") \
                and spec.sim is not None:
            opts.setdefault("sim", spec.sim)
        payload = builders[section](space, spec.verbose, dev, **opts)
        out[section] = FrontierReport(section=section, payload=payload)
    return out


def _frontier_section(space, verbose, device, *,
                      metric: str = "bandwidth_gbs", dim: str = "system",
                      mode: str = "max", constraints=None, sim=None,
                      stream=None) -> Dict[str, Any]:
    """The calling space's own winner map — materialized
    (``SpaceResult.frontier``) or streamed (``StreamConfig``), one payload
    schema for both."""
    if stream is not None:
        res = space.evaluate(metrics=(metric,), sim=sim, stream=stream)
        winners = res.winners
        extra = {"engine": "streaming", "win_counts": res.win_counts,
                 "n_cells": res.n_cells,
                 "peak_cells_per_chunk": res.peak_cells_per_chunk,
                 "devices": res.devices, "compiles": res.compiles}
        mode = res.mode
    else:
        metrics = [metric]
        if constraints is not None:
            if constraints.max_power_w is not None:
                metrics.append("power_w")
            if constraints.required_bandwidth_gbs is not None:
                metrics.append("bandwidth_gbs")
        res = space.evaluate(metrics=tuple(dict.fromkeys(metrics)),
                             sim=sim)
        where = res.feasible(constraints) if constraints is not None \
            else None
        winners = res.frontier(metric, dim, mode, where=where)
        extra = {"engine": "materialized"}
    payload = {"metric": metric, "dim": dim, "mode": mode,
               "dims": list(winners.dims),
               "coords": [[str(c) for c in coord]
                          for coord in winners.coords],
               "winners": np.asarray(winners.values, dtype=object)
               .tolist(), **extra}
    if verbose:
        print(f"frontier: {metric} argbest({dim!r}, {mode!r}) over dims "
              f"{payload['dims']} [{extra['engine']}]")
    return payload


def _joint_section(space, verbose, device, **opts) -> Dict[str, Any]:
    from repro_torch.core.space import joint_frontier
    t0 = time.perf_counter()
    jf = joint_frontier(device=device, **opts)
    dt = time.perf_counter() - t0
    if verbose:
        n_jf = (len(jf["read_fractions"]) * len(jf["backlogs"])
                * len(jf["shorelines"]))
        print(f"analytic-vs-simulated frontier: {n_jf} joint "
              f"(mix x backlog x shoreline) points in {dt:.2f}s; winners "
              f"disagree on {jf['disagreement_fraction']:.0%} of the "
              f"space")
    return jf


def _phy_section(space, verbose, device, *, n_fracs: int = 21,
                 shorelines=(4.0, 8.0, 16.0)) -> Dict[str, Any]:
    """The catalog across UCIe-A/UCIe-S at 32G plus the 48G points, in
    ONE PHY-stacked evaluation."""
    from repro_torch.core.space import DesignSpace, axis, regimes
    from repro_torch.core.ucie import (
        UCIE_A_32G_55U, UCIE_A_48G_45U, UCIE_S_32G, UCIE_S_48G_110U,
    )
    phys = [UCIE_S_32G, UCIE_A_32G_55U, UCIE_S_48G_110U, UCIE_A_48G_45U]
    fracs = np.linspace(0.0, 1.0, n_fracs)
    t0 = time.perf_counter()
    res = DesignSpace([
        axis("phy", phys),
        axis("read_fraction", fracs),
        axis("shoreline_mm", shorelines),
    ], device=device).evaluate(metrics=("bandwidth_gbs", "gbs_per_watt"))
    dt = time.perf_counter() - t0
    bw = res["bandwidth_gbs"]          # [S, F, M, L]
    if verbose:
        print(f"phy axis: {len(phys)} PHYs x {len(bw.coord('system'))} "
              f"approaches x {n_fracs} mixes x {len(shorelines)} "
              f"shorelines = {int(np.prod(bw.shape))} points in "
              f"{dt:.2f}s")
    report = {"phys": [p.name for p in phys],
              "read_fractions": fracs.tolist(),
              "shorelines": [float(s) for s in shorelines],
              "best_approach_by_phy": {}, "regimes_by_phy": {}}
    for p in phys:
        front = res.frontier("bandwidth_gbs").sel(phy=p.name,
                                                  shoreline_mm=8.0)
        regs = regimes(front.values.tolist(), fracs)
        report["regimes_by_phy"][p.name] = [
            {"read_fraction_lo": lo, "read_fraction_hi": hi,
             "best": str(lab)} for lo, hi, lab in regs]
        at70 = front.values[int(round(0.7 * (n_fracs - 1)))]
        report["best_approach_by_phy"][p.name] = str(at70)
        if verbose:
            peak = float(bw.sel(phy=p.name,
                                shoreline_mm=8.0).values.max())
            print(f"    {p.name:18s} best@70R30W {at70:24s} "
                  f"peak {peak:6.0f} GB/s @ 8 mm")
    # §V scaling check: at the same bump pitch 48G carries 48/32 = 1.5x
    # the bandwidth at identical pJ/b
    g32 = float(bw.sel(phy=UCIE_S_32G.name).values.max())
    g48 = float(bw.sel(phy=UCIE_S_48G_110U.name).values.max())
    report["bw_gain_48g_vs_32g_same_pitch"] = g48 / g32
    if verbose:
        print(f"    48G vs 32G same-pitch bandwidth gain: "
              f"x{g48 / g32:.2f} at constant pJ/b")
    return report


def _sim_phy_section(space, verbose, device, *, n_fracs: int = 21,
                     backlogs=(2.0, 64.0), sim=None) -> Dict[str, Any]:
    """Simulation-corrected PHY-absolute frontier: simulated efficiency
    threaded onto each PHY generation's raw link bandwidth, per queue
    depth (default: the adaptive engine)."""
    from repro_torch.core import flitsim
    from repro_torch.core.selector import approach_key_for
    from repro_torch.core.space import (
        ADAPTIVE_SIM, DesignSpace, axis, regimes,
    )
    from repro_torch.core.ucie import (
        UCIE_A_32G_55U, UCIE_A_48G_45U, UCIE_S_32G, UCIE_S_48G_110U,
    )
    sim = sim if sim is not None else ADAPTIVE_SIM
    phys = [UCIE_S_32G, UCIE_A_32G_55U, UCIE_S_48G_110U, UCIE_A_48G_45U]
    fracs = np.linspace(0.0, 1.0, n_fracs)
    t0 = time.perf_counter()
    res = DesignSpace([
        axis("phy", phys),
        axis("read_fraction", fracs),
        axis("backlog", backlogs),
    ], sim=sim, device=device).evaluate(
        metrics=("sim_efficiency", "sim_bandwidth_gbs"))
    dt = time.perf_counter() - t0
    bw = res["sim_bandwidth_gbs"]      # [protocol, phy, backlog, mix]
    info = flitsim.last_run_info()
    cycles = {fam.split(".")[1]: d["cycles_run"] for fam, d in info.items()
              if d["mode"] == "adaptive"}
    if verbose:
        print(f"sim-phy frontier: {len(bw.coord('protocol'))} protocols "
              f"x {len(phys)} PHYs x {len(backlogs)} backlogs x "
              f"{n_fracs} read fractions = {int(np.prod(bw.shape))} "
              f"points in {dt:.2f}s [adaptive cycles {cycles}]")
    report = {"phys": [p.name for p in phys],
              "backlogs": [float(b) for b in backlogs],
              "read_fractions": fracs.tolist(),
              "adaptive_cycles": cycles,
              "peak_sim_gbs_by_phy": {},
              "best_protocol_by_phy": {},
              "regimes_by_phy_backlog": {}}
    for p in phys:
        regs_by_bl = {}
        for b in backlogs:
            front = bw.sel(phy=p.name, backlog=b).argbest("protocol")
            regs_by_bl[f"{b:g}"] = [
                {"read_fraction_lo": lo, "read_fraction_hi": hi,
                 "best": str(lab),
                 "approach": approach_key_for(str(lab))}
                for lo, hi, lab in regimes(front.values.tolist(), fracs)]
        report["regimes_by_phy_backlog"][p.name] = regs_by_bl
        deep = bw.sel(phy=p.name, backlog=backlogs[-1])
        at70 = deep.argbest("protocol").values[
            int(round(0.7 * (n_fracs - 1)))]
        report["best_protocol_by_phy"][p.name] = str(at70)
        peak = float(deep.values.max())
        report["peak_sim_gbs_by_phy"][p.name] = peak
        if verbose:
            print(f"    {p.name:18s} best@70R30W {str(at70):12s} "
                  f"peak {peak:5.0f} GB/s (raw link, simulated)")
    # the shallow-queue disagreement the closed forms cannot see
    shallow = {p.name: [r["best"]
                        for r in report["regimes_by_phy_backlog"][p.name]
                        [f"{backlogs[0]:g}"]] for p in phys}
    deep_w = {p.name: [r["best"]
                       for r in report["regimes_by_phy_backlog"][p.name]
                       [f"{backlogs[-1]:g}"]] for p in phys}
    report["shallow_queue_disagrees"] = {
        name: shallow[name] != deep_w[name] for name in shallow}
    return report


def _serving_section(space, verbose, device, *, models=None,
                     qps_points=None, **kwargs) -> Dict[str, Any]:
    from repro_torch.core.space import DesignSpace
    rep = DesignSpace.serving_frontier(models, qps_points, device=device,
                                       **kwargs)
    if verbose:
        print(f"serving frontier: {len(rep['models'])} models x "
              f"{len(rep['qps_points'])} QPS points x "
              f"{len(rep['protocols'])} protocols on {rep['phy']}")
    return rep
