#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result's JSON object; the
numbers the correctness check compared, each beside its limit, are the
last lines of standard error.  Exits with 3, printing no result, without
enough CUDA cards; with 4 if JAX or the JAX package was loaded; with 2 if
the port cannot be imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the engine's host work is one Python
# thread, and idle OpenMP workers only take cores from it
os.environ.setdefault("OMP_NUM_THREADS", "1")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from bench_port import spec
    cell = spec.load_cell(args.workload)

    import torch
    torch.set_num_threads(1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"bench_port: {args.workload} needs {cell.chips} CUDA "
              f"card(s), found {have}", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench_port: the port is missing from this checkout: {e}",
              file=sys.stderr)
        return 2
    from bench_port.session import execute
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {bad}; the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
