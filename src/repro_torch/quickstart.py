"""Quickstart: the paper's models in five minutes — port of
``examples/quickstart.py``.

    python -m repro_torch.quickstart [--device cpu]

Evaluates every UCIe-Memory approach (A-E) against the HBM4/LPDDR6
incumbents across traffic mixes, validates the closed forms against the
flit-level simulator, and picks the best memory system for a workload —
the paper's §IV in one script.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from repro_torch import device as device_mod


def collect(device=None) -> Dict[str, Any]:
    """The values the script prints, computed on ``device`` (default
    ``"cuda"``): ``linear_density`` / ``pj_per_bit`` per approach per
    paper mix (plus the HBM4/LPDDR6 bus rows), ``latency_speedup``,
    ``sim_vs_analytic`` at 2R1W per simulated protocol, ``ranking`` (the
    top five systems for 2R1W at 8 mm) and ``best`` by GB/s per watt."""
    from repro_torch.core.flitsim import ANALYTIC, SIMULATORS
    from repro_torch.core.latency import latency_speedup
    from repro_torch.core.protocols import ALL_APPROACHES, HBM4, LPDDR6
    from repro_torch.core.selector import best, rank
    from repro_torch.core.traffic import PAPER_MIXES, TrafficMix
    from repro_torch.core.ucie import UCIE_A_32G_55U, UCIE_S_32G
    dev = device_mod.resolve(device)
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    mixes = [m.name for m in PAPER_MIXES]
    density: Dict[str, list] = {}
    pjb: Dict[str, list] = {}
    for key, proto in ALL_APPROACHES.items():
        density[key] = [float(proto.bw_density_linear(
            f32(m.x), f32(m.y), UCIE_A_32G_55U)) for m in PAPER_MIXES]
        pjb[key] = [float(proto.power_pj_per_bit(f32(m.x), f32(m.y),
                                                 UCIE_S_32G))
                    for m in PAPER_MIXES]
    bus = {"HBM4 (optimistic bus)": float(HBM4.linear_density_gbs_mm),
           "LPDDR6 (optimistic bus)": float(LPDDR6.linear_density_gbs_mm)}
    sim = {}
    for key, fn in SIMULATORS.items():
        a = float(ANALYTIC[key].bw_eff(f32(2), f32(1)))
        sim[key] = {"analytic": a, "simulated": fn(2, 1, device=dev)}
    ranking = [{"key": r.key, "bandwidth_gbs": r.bandwidth_gbs,
                "pj_per_bit": r.pj_per_bit, "latency_ns": r.latency_ns}
               for r in rank(TrafficMix(2, 1), device=dev)[:5]]
    b = best(TrafficMix(2, 1), objective="gbs_per_watt", device=dev)
    return {"mixes": mixes, "linear_density": density, "bus_density": bus,
            "pj_per_bit": pjb, "latency_speedup": latency_speedup(),
            "sim_vs_analytic": sim, "ranking": ranking,
            "best": {"key": b.key, "gbs_per_watt": b.gbs_per_watt}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    q = collect(args.device)
    print("=" * 72)
    print("UCIe-Memory (approaches A-E) vs HBM4 / LPDDR6 — paper Figs 10-12")
    print("=" * 72)
    hdr = f"{'approach':26s} " + " ".join(f"{m:>8s}" for m in q["mixes"])
    print("\nLinear bandwidth density (GB/s/mm), UCIe-A @55um:")
    print(hdr)
    for key, vals in q["linear_density"].items():
        print(f"{key:26s} " + " ".join(f"{v:8.0f}" for v in vals))
    for name, v in q["bus_density"].items():
        print(f"{name:26s} " + " ".join(f"{v:8.0f}" for _ in q["mixes"]))

    print("\nPower efficiency (pJ/b), UCIe-S vs HBM4=0.9:")
    print(hdr)
    for key, vals in q["pj_per_bit"].items():
        print(f"{key:26s} " + " ".join(f"{v:8.3f}" for v in vals))

    print("\nLatency speedups vs incumbents:", q["latency_speedup"])

    print("\nFlit-level simulator vs closed forms (2R1W):")
    for key, r in q["sim_vs_analytic"].items():
        a, s = r["analytic"], r["simulated"]
        print(f"  {key:14s} analytic={a:.4f} simulated={s:.4f} "
              f"err={abs(a - s) / a:.3%}")

    print("\nBest memory system for a 2R1W workload, 8mm shoreline:")
    for r in q["ranking"]:
        print(f"  {r['key']:32s} {r['bandwidth_gbs']:8.0f} GB/s  "
              f"{r['pj_per_bit']:.3f} pJ/b  {r['latency_ns']:.0f} ns")
    b = q["best"]
    print(f"\npaper conclusion check — best power-efficient performance: "
          f"{b['key']} ({b['gbs_per_watt']:.1f} GB/s per W)")


if __name__ == "__main__":
    main()
