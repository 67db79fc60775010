#!/usr/bin/env python3
"""Readings that set a cell's correctness limit, many seeds in one
process (the card's set-up is paid once).

    python3 bench_port/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 10 [--out readings.jsonl]

For each seed: the cell's set-up and a window of ``--seconds`` at the
cell's own load, then the sampled requests through the f32 reference.  A
line per seed gives the program's widest gap of a served token
(``served_max``, the lower reading's sample) and the control's: the
reference in fp8 in the program's place, its top token at each of the
same positions judged by the f32 reference (``fp8_max``, the upper
reading's sample).  Not part of a benchmark run.

Two readings for a configuration with experts: ``--count-drops`` adds the
(token, choice) pairs the port's decode ticks dropped past an expert's
capacity (counted from the share each MoE call computes), and
``--capacity-factor`` serves and checks the cell with another capacity
factor on both sides (8 makes every forward dropless).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--count-drops", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=None)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import numpy as np
    import torch
    from bench_port import spec
    from bench_port.session import readings, serve

    cell = spec.load_cell(args.workload)
    if args.capacity_factor is not None:
        cell.config["model"]["moe_capacity_factor"] = args.capacity_factor
    drops = count_drops(cell.batch_slots) if args.count_drops else None
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if drops is not None:
            drops.clear()
        sv = serve(cell, seed, args.seconds, False, dev, t0)
        t1 = time.perf_counter()
        chosen, g = readings(cell, sv, seed, ("fp8",))
        rec = {"workload": cell.name, "seed": seed,
               "capacity_factor": cell.config["model"].get(
                   "moe_capacity_factor"),
               "requests": len(chosen), "tokens": int(g["served"].size),
               "served_max": float(g["served"].max()),
               "served_p99": float(np.percentile(g["served"], 99)),
               "served_nonzero": int((g["served"] > 0).sum()),
               "fp8_max": float(g["fp8"].max()),
               "fp8_nonzero": int((g["fp8"] > 0).sum()),
               "setup_s": sv.setup_s, "build_s": sv.build_s,
               "check_s": time.perf_counter() - t1,
               "finished": len(sv.window.finished()),
               "peak_gb": sv.memory_peak_bytes / 1e9,
               "card": torch.cuda.get_device_name(dev)}
        if drops is not None:
            rec.update(drops.totals())
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del sv
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


class DropCount(list):
    """(dropped pairs, pairs) of every MoE call of at most ``slots``
    tokens (a decode tick's; a prefill holds 128 tokens or more)."""

    def totals(self):
        calls = [(float(d), n) for d, n in self]
        return {"decode_moe_calls": len(calls),
                "decode_pairs": sum(n for _, n in calls),
                "decode_pairs_dropped": round(sum(d for d, _ in calls)),
                "decode_calls_with_drops": sum(d > 0.5 for d, _ in calls)}


def count_drops(slots: int) -> DropCount:
    """Wrap the port's ``moe_local`` to record the pairs each decode
    tick's MoE call dropped (its returned share times its pairs)."""
    from repro_torch.models import moe
    orig, seen = moe.moe_local, DropCount()

    def counted(xt, *args, **kw):
        out = orig(xt, *args, **kw)
        if xt.shape[0] <= slots:
            pairs = xt.shape[0] * args[4].experts_per_token
            seen.append((out[2].detach() * pairs, pairs))
        return out
    moe.moe_local = counted
    return seen


if __name__ == "__main__":
    sys.exit(main())
