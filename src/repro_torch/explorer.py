"""Memory-system explorer, bridge mode — port of the ``--bridge`` mode of
``examples/memsys_explorer.py``.

    python -m repro_torch.explorer --bridge [--out DIR] [--device cpu]

Stacks every workload's traffic mix (the representative train / prefill /
decode workloads below) as a ``workload_config`` axis on top of the dense
mix grid and a shoreline axis, resolves the whole [configs x catalog x
mixes x shorelines] space, then builds the joint analytic-vs-simulated
frontier, the PHY-stacked frontier and its cycle-level counterpart, and
writes the report to ``DIR/design_space.json`` (default
``experiments/torch_dryrun/``).  The flit-simulated sections run the
adaptive engine on the CUDA kernels.  The serving section waits for the
traces slice.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

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
    dev = device_mod.resolve(device)
    say = print if verbose else (lambda *a, **k: None)
    reports = representative_reports()
    say("no dry-run artifacts; using representative workloads")
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
    if out_dir is not None or verbose:
        out = Path(out_dir) if out_dir is not None else DEFAULT_OUT
        out.mkdir(parents=True, exist_ok=True)
        with open(out / DESIGN_SPACE_JSON, "w") as f:
            json.dump(ds, f, indent=1)
        say(f"\nwrote {out / DESIGN_SPACE_JSON}")
    return ds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bridge", action="store_true", required=True,
                    help="workload -> design-space bridge (the only mode "
                         "this port has so far)")
    ap.add_argument("--out", default=None,
                    help=f"output directory (default {DEFAULT_OUT})")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    bridge_mode(args.out, device=args.device)


if __name__ == "__main__":
    main()
