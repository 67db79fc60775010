"""Memory-system explorer — port of ``examples/memsys_explorer.py``.

    python -m repro_torch.explorer [CELL.json] [--out DIR]
    python -m repro_torch.explorer --bridge [--out DIR] [--device cpu]
    python -m repro_torch.explorer --sweep [--device cpu]
    python -m repro_torch.explorer --serving [--device cpu]

The default mode prints one dry-run cell's roofline and its memory
systems (:func:`explore`): the given artifact, or the first three cell
artifacts of ``DIR`` (default ``experiments/torch_dryrun/``, where
``python -m repro_torch.launch.dryrun`` writes them); files that are not
cells (``design_space.json``, axes-first exports) are skipped.

Sweep mode flit-simulates every protocol over a dense read-fraction x
backlog grid with the adaptive engine (the ``symmetric_run`` and
``asymmetric_periodic`` kernels on the card), prints the best protocol per
read-fraction regime at backlog 64, and ranks the catalog over the same
read-fraction axis.

Bridge mode stacks every workload's traffic mix (the dry-run cells of
``DIR`` where there are any, else the representative train / prefill /
decode workloads below) as a ``workload_config`` axis on top of the dense
mix grid and a shoreline axis, resolves the whole [configs x catalog x
mixes x shorelines] space, then builds the joint analytic-vs-simulated
frontier, the PHY-stacked frontier, its cycle-level counterpart and the
serving-trace frontier, and writes the report to ``DIR/design_space.json``
(default ``experiments/torch_dryrun/``).  The flit-simulated sections run
the adaptive engine on the CUDA kernels, the serving section the trace
kernels (``symmetric_trace``, ``asymmetric_trace``: one launch each).

Serving mode prints the serving-trace frontier alone: which memory
approach wins at which (model, QPS) point.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import device as device_mod

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "experiments" \
    / "torch_dryrun"

#: The reference's model inputs when no dry-run artifacts exist: per-chip
#: (read bytes, write bytes, HLO bytes) of a training step (reads weights
#: and activations, writes gradients), a read-heavy prefill and a decode
#: that is nearly pure weight streaming.
REPRESENTATIVE_WORKLOADS = {
    "train_67R33W": (6.7e9, 3.3e9, 1.0e10),
    "prefill_85R15W": (1.27e10, 2.3e9, 1.5e10),
    "decode_95R5W": (1.9e10, 1.0e9, 2.0e10),
}
#: the reference's HBM-baseline rate for ``memory_s`` (bytes/s), a model
#: input of the bridge, not a property of the card the port runs on
HBM_BASELINE_BYTES_PER_S = 8.192e11


def _runs(labels: Sequence[Any], fracs: np.ndarray
          ) -> List[Tuple[float, float, str]]:
    """Contiguous ``(first fraction, last fraction, label)`` runs along the
    read-fraction axis, as the reference's sweep mode prints them."""
    out = []
    start = 0
    for j in range(1, len(labels) + 1):
        if j == len(labels) or labels[j] != labels[start]:
            out.append((float(fracs[start]), float(fracs[j - 1]),
                        str(labels[start])))
            start = j
    return out


def sweep_mode(n_fracs: int = 41,
               backlogs: Sequence[float] = (1, 2, 4, 8, 16, 32, 64, 128),
               *, device=None, verbose: bool = True) -> Dict[str, Any]:
    """Dense design-space sweep: read fraction x backlog x protocol, with
    the adaptive engine on ``device`` (default ``"cuda"``), then the
    catalog ranking over the same read-fraction axis.

    Returns ``efficiency`` ``[P, B, M]``, ``protocols``, ``fracs``,
    ``regimes`` (best simulated protocol per read-fraction run at backlog
    64, or the last backlog), ``catalog_regimes`` (best catalog system by
    bandwidth per run), ``launches`` (kernel launches of the sweep),
    ``run_info`` (the engines' :func:`flitsim.last_run_info`) and
    ``sim_s`` (wall seconds of the simulated part)."""
    from repro_torch.core import flitsim
    from repro_torch.core.space import ADAPTIVE_SIM, DesignSpace, axis
    from repro_torch.core.traffic import mix_grid
    from repro_torch.kernels.flit_sim import ops as fs_ops
    dev = device_mod.resolve(device)
    say = print if verbose else (lambda *a, **k: None)
    x, _ = mix_grid(n_fracs, device="cpu")
    fracs = x.numpy() / 100.0

    before = dict(fs_ops.launches)
    t0 = time.perf_counter()
    res = DesignSpace([
        axis("backlog", list(backlogs)),
        axis("read_fraction", fracs),
    ], sim=ADAPTIVE_SIM, device=dev).evaluate(metrics=("sim_efficiency",))
    sa = res["sim_efficiency"]
    protocols = list(sa.coord("protocol"))
    eff = np.asarray(sa.values)                   # [P, B, M]
    t_sim = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in fs_ops.launches.items()}
    run_info = {fam: info for fam, info in flitsim.last_run_info().items()
                if info["mode"] == "adaptive"}
    say(f"flit-simulated {eff.size} grid points "
        f"({len(protocols)} protocols x {len(backlogs)} backlogs x "
        f"{n_fracs} read fractions) in {t_sim:.2f}s on {dev} "
        f"[kernel launches {launches}]")
    for fam, info in sorted(run_info.items()):
        say(f"    {fam.split('.')[1]:10s} adaptive: "
            f"{info['cycles_run']}/{info['horizon']} cycles "
            f"({info['stragglers']} stragglers re-simulated exactly)")

    bl = list(backlogs)
    bl_ref = bl.index(64) if 64 in bl else len(bl) - 1
    say(f"\nsimulated data efficiency at backlog={bl[bl_ref]} "
        f"(read fraction 0 / 0.5 / 1):")
    mid = n_fracs // 2
    for i, key in enumerate(protocols):
        e = eff[i, bl_ref]
        sens = float(np.max(eff[i, :, mid]) - np.min(eff[i, :, mid]))
        say(f"    {key:12s} {e[0]:.3f} / {e[mid]:.3f} / {e[-1]:.3f}   "
            f"backlog sensitivity @50/50: {sens:.3f}")

    say("\nbest simulated protocol per read-fraction regime "
        f"(backlog={bl[bl_ref]}):")
    best = np.argmax(eff[:, bl_ref, :], axis=0)
    regimes = _runs([protocols[b] for b in best], fracs)
    for lo, hi, key in regimes:
        say(f"    read fraction {lo:.2f}-{hi:.2f}: {key}")

    # catalog ranking over the same read-fraction axis
    t0 = time.perf_counter()
    cres = DesignSpace([axis("read_fraction", fracs)], device=dev).evaluate(
        metrics=("bandwidth_gbs",))
    keys = cres.frontier("bandwidth_gbs").values
    n_sys = len(cres["bandwidth_gbs"].coord("system"))
    t_rank = time.perf_counter() - t0
    say(f"\ncatalog ranking over {n_fracs} read fractions "
        f"({n_sys} systems) in {t_rank*1e3:.1f} ms:")
    catalog_regimes = _runs(list(keys), fracs)
    for lo, hi, key in catalog_regimes:
        say(f"    read fraction {lo:.2f}-{hi:.2f}: {key}")
    return {"efficiency": eff, "protocols": protocols, "fracs": fracs,
            "backlogs": [float(b) for b in bl], "regimes": regimes,
            "catalog_regimes": catalog_regimes, "launches": launches,
            "run_info": run_info, "sim_s": t_sim}


def cell_artifacts(directory: Optional[os.PathLike] = None
                   ) -> List[Tuple[str, Dict[str, Any]]]:
    """The decoded per-cell dry-run artifacts of ``directory`` (default
    :data:`DEFAULT_OUT`) as ``(path, dict)`` pairs in file-name order;
    anything that is not a workload cell is skipped."""
    from repro_torch.roofline.analysis import is_cell_artifact
    d = Path(directory) if directory is not None else DEFAULT_OUT
    out = []
    for f in sorted(d.glob("*.json")):
        try:
            with open(f) as fh:
                cell = json.load(fh)
        except (OSError, ValueError):
            continue
        if is_cell_artifact(cell):
            out.append((str(f), cell))
    return out


def explore(d: Dict[str, Any]) -> None:
    """Print one cell's roofline and each memory system's bandwidth, energy
    and memory term for its traffic mix (the reference's lines)."""
    r = d["roofline"]
    br = d["memsys_bridge"]
    print(f"cell: {d['arch']} × {d['shape']} × {d['mesh']} "
          f"({d['chips']} chips)")
    print(f"  traffic mix (from HLO bytes): {br['mix']} "
          f"(read fraction {br['read_fraction']:.2f})")
    print(f"  roofline: compute {r['compute_s']*1e3:.1f} ms | "
          f"memory {r['memory_s']*1e3:.1f} ms | "
          f"collective {r['collective_s']*1e3:.1f} ms  "
          f"-> {r['dominant']}-bound")
    print(f"\n  memory systems for this workload "
          f"(8 mm shoreline; HBM-baseline memory term "
          f"{br['hbm_baseline_memory_s']*1e3:.1f} ms):")
    rows = sorted(br["systems"].items(),
                  key=lambda kv: kv[1]["memory_term_s"])
    for key, s in rows:
        print(f"    {key:32s} {s['bandwidth_gbs']:8.0f} GB/s  "
              f"{s['pj_per_bit']:.3f} pJ/b  {s['latency_ns']:4.1f} ns  "
              f"memory term {s['memory_term_s']*1e3:8.2f} ms  "
              f"{s['interconnect_energy_j_per_step']:.2f} J/step")


def explore_mode(cell: Optional[os.PathLike] = None,
                 directory: Optional[os.PathLike] = None) -> int:
    """The default mode: :func:`explore` of ``cell`` or of the first three
    cell artifacts of ``directory``; returns how many it printed."""
    if cell is not None:
        with open(cell) as fh:
            cells = [json.load(fh)]
    else:
        cells = [d for _, d in cell_artifacts(directory)[:3]]
    if not cells:
        print("no dry-run artifacts; run "
              "`PYTHONPATH=src python -m repro_torch.launch.dryrun --all` "
              "first (or try `--sweep` for the design-space sweep, which "
              "needs no artifacts)")
        return 0
    for d in cells:
        explore(d)
        print()
    return len(cells)


def representative_reports() -> Dict[str, Any]:
    from repro_torch.roofline.analysis import RooflineReport
    return {
        name: RooflineReport(
            arch=name, shape="-", mesh="-", chips=256,
            hlo_flops_per_chip=0.0, hlo_bytes_per_chip=hb,
            collective_bytes_per_chip=0.0, compute_s=0.0,
            memory_s=hb / HBM_BASELINE_BYTES_PER_S, collective_s=0.0,
            dominant="memory", model_flops=0.0, useful_flops_ratio=0.0,
            read_bytes_per_chip=r, write_bytes_per_chip=w)
        for name, (r, w, hb) in REPRESENTATIVE_WORKLOADS.items()}


def serving_frontier_report(models=None, qps_points=None, *, device=None,
                            verbose: bool = True, **kwargs
                            ) -> Dict[str, Any]:
    """Serving-trace frontier on ``device`` (default ``"cuda"``): which
    memory approach wins at which (model, QPS) point.  Synthetic serving
    traces (config shapes only, no weights) are evaluated through the
    design space's ``trace`` axis — queue/credit state carried across
    phase boundaries — and each (model, QPS) cell's winning protocol on
    the UCIe-A PHY is mapped to its catalog memory approach.  Prints the
    frontier and the trace-scan telemetry (unless not ``verbose``);
    returns the ``serving_frontier`` section of ``design_space.json``
    (through the report API, section ``"serving"``)."""
    from repro_torch.core.report import ReportSpec, build_report
    dev = device_mod.resolve(device)
    say = print if verbose else (lambda *a, **k: None)
    t0 = time.perf_counter()
    opts = dict(kwargs, models=models, qps_points=qps_points)
    spec = ReportSpec(sections=("serving",), options={"serving": opts})
    rep = build_report(spec, device=dev)["serving"].payload
    dt = time.perf_counter() - t0
    say(f"serving frontier: {len(rep['models'])} models x "
        f"{len(rep['qps_points'])} QPS points x "
        f"{len(rep['protocols'])} protocols ({rep['n_phases']} phases "
        f"per trace, {rep['arrival']} arrivals) in {dt:.2f}s on {dev} "
        f"[kernel launches {rep['launches']}, {rep['phy']}]")
    for fam, tele in sorted(rep["telemetry"].items()):
        say(f"    {fam.split('.')[1]:10s} trace-scan: "
            f"{tele['phases']} phases x {tele['cycles_per_phase']} "
            f"cycles ({tele['trace_cells']} cells, state carried "
            f"across {tele['state_carry_depth']} cycles)")
    for m in rep["models"]:
        wins = rep["winner_by_model_qps"][m]
        gbs = rep["winner_gbs_by_model_qps"][m]
        pts = "  ".join(
            f"qps={q}: {wins[q]} ({gbs[q]:.0f} GB/s)" for q in wins)
        tag = "QPS-SENSITIVE" if rep["qps_sensitive"][m] else \
            "qps-insensitive"
        say(f"    {m:14s} {pts}  [{tag}]")
    if rep["models"] and rep["qps_points"] and \
            not any(rep["qps_sensitive"].values()):
        say("    (one approach serves every load point on this PHY)")
    return rep


def serving_mode(*, device=None) -> Dict[str, Any]:
    """``--serving``: print the serving-trace frontier alone, then every
    synthetic trace's phases."""
    rep = serving_frontier_report(device=device)
    traces = rep["traces"]
    print(f"\n{len(traces)} synthetic traces "
          f"({rep['n_ticks']} engine ticks each):")
    for name in rep["trace_names"]:
        t = traces[name]
        rf = "/".join(f"{r:.2f}" for r in t["read_fractions"])
        bl = "/".join(f"{b:.0f}" for b in t["backlogs"])
        print(f"    {name:22s} read fraction {rf}  backlog {bl}")
    return rep


def bridge_mode(out_dir: Optional[os.PathLike] = None, *,
                n_fracs: int = 41, shorelines=(2.0, 4.0, 8.0, 16.0),
                device=None, verbose: bool = True) -> Dict[str, Any]:
    """Build the design-space report on ``device`` (default ``"cuda"``),
    write ``design_space.json`` into ``out_dir`` (unless ``None`` and
    ``verbose`` is False — then nothing is written) and return it."""
    from repro_torch.core.report import ReportSpec, build_report
    from repro_torch.core.space import ADAPTIVE_SIM
    from repro_torch.roofline.analysis import (
        DESIGN_SPACE_JSON, bridge_design_space,
    )
    from repro_torch.roofline.analysis import RooflineReport
    dev = device_mod.resolve(device)
    say = print if verbose else (lambda *a, **k: None)
    reports = {f"{d['arch']}__{d['shape']}__{d['mesh']}":
               RooflineReport(**d["roofline"])
               for _, d in cell_artifacts(out_dir)}
    if reports:
        say(f"{len(reports)} workload cells from dry-run artifacts")
    else:
        say("no dry-run artifacts; using representative workloads")
        reports = representative_reports()
    t0 = time.perf_counter()
    ds = bridge_design_space(reports, n_fracs=n_fracs,
                             shorelines=shorelines, device=dev)
    dt = time.perf_counter() - t0
    n_pts = (len(reports) * len(ds["keys"]) * (n_fracs + 1)
             * len(shorelines))
    say(f"design space: {len(reports)} workloads x {len(ds['keys'])} "
        f"systems x {n_fracs + 1} mixes x {len(shorelines)} shorelines "
        f"= {n_pts} points in {dt:.2f}s on {dev}\n")
    for name, w in ds["workloads"].items():
        hbm_t = w["hbm_baseline_memory_s"]
        best_t = w["systems"][w["best"]]["memory_term_s"]
        say(f"{name}  ({w['mix']}, read fraction "
            f"{w['read_fraction']:.2f})")
        say(f"    best @ {ds['reference_shoreline_mm']:g} mm: "
            f"{w['best']}  memory term {best_t*1e3:.2f} ms "
            f"(HBM baseline {hbm_t*1e3:.2f} ms, x{hbm_t / best_t:.2f})")
        say("    read-fraction frontier: " + ", ".join(
            f"{c['read_fraction_lo']:.2f}-{c['read_fraction_hi']:.2f}:"
            f"{c['best']}" for c in w["crossovers"]))
        if w["shoreline_sensitive"]:
            say(f"    shoreline-SENSITIVE: {w['shoreline_frontier']}")
        else:
            say("    shoreline-insensitive (" + ", ".join(
                f"{s:g}" for s in ds["shorelines"]) + " mm)")
        say()

    # joint analytic-vs-simulated frontier, the PHY-stacked frontier and
    # its cycle-level counterpart (adaptive engine on the CUDA kernels)
    sections = build_report(
        ReportSpec(sections=("joint", "phy", "sim_phy"), sim=ADAPTIVE_SIM,
                   verbose=verbose), device=dev)
    jf = sections["joint"].payload
    say("    worst simulated-vs-analytic efficiency error: " + ", ".join(
        f"{k}={v:.1%}" for k, v in jf["protocol_rel_err"].items()))
    for r in jf["disagreement_regions"][:8]:
        say(f"      backlog={r['backlog']:g} "
            f"shoreline={r['shoreline_mm']:g}mm read fraction "
            f"{r['read_fraction_lo']:.2f}-{r['read_fraction_hi']:.2f}"
            f": analytic {r['analytic_best']} -> simulated "
            f"{r['simulated_best']}")
    ds["joint_frontier"] = jf
    ds["phy_frontier"] = sections["phy"].payload
    ds["sim_phy_frontier"] = sections["sim_phy"].payload
    # ...and the serving-trace frontier: time-varying traffic from the LM
    # serving workloads, winners per (model, QPS) point
    say()
    ds["serving_frontier"] = serving_frontier_report(device=dev,
                                                     verbose=verbose)
    if out_dir is not None or verbose:
        out = Path(out_dir) if out_dir is not None else DEFAULT_OUT
        out.mkdir(parents=True, exist_ok=True)
        with open(out / DESIGN_SPACE_JSON, "w") as f:
            json.dump(ds, f, indent=1)
        say(f"\nwrote {out / DESIGN_SPACE_JSON}")
    return ds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell", nargs="?", default=None,
                    help="a dry-run cell artifact to explore (default "
                         "mode)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--bridge", action="store_true",
                      help="workload -> design-space bridge")
    mode.add_argument("--sweep", action="store_true",
                      help="dense read-fraction x backlog sweep")
    mode.add_argument("--serving", action="store_true",
                      help="serving-trace frontier per (model, QPS)")
    ap.add_argument("--out", default=None,
                    help=f"the dry-run artifacts' directory, where the "
                         f"bridge writes its report (default {DEFAULT_OUT})")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.sweep:
        sweep_mode(device=args.device)
    elif args.serving:
        serving_mode(device=args.device)
    elif args.bridge:
        bridge_mode(args.out, device=args.device)
    else:
        explore_mode(args.cell, args.out)


if __name__ == "__main__":
    main()
