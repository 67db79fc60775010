#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``).  Phases, each fatal
on failure:

1. card: print ``nvidia-smi``'s name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   card, bitwise (``torch.equal``), at the design-space bridge's shapes and
   at about 2^20 cells, with CUDA-event timings of both;
4. main path: the explorer's ``--bridge`` run on the card at full width,
   its summary held against ``experiments/golden/design_space_summary.json``
   (every section but the serving one), the launch counts of the
   ``asymmetric_periodic`` and ``symmetric_chunk`` kernels read around it;
   then a shallow-queue design space (backlogs 1, 2, 4 x 21 read
   fractions), which runs ``symmetric_periodic``, its detected cells held
   bitwise against the fixed engine;
5. report: one ``{"kernels": [...]}`` line, then the result line.
"""
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch.core import flitsim  # noqa: E402
from repro_torch.core.space import ADAPTIVE_SIM, DesignSpace, axis  # noqa: E402
from repro_torch.explorer import bridge_mode  # noqa: E402
from repro_torch.kernels.flit_sim import ops, ref  # noqa: E402

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
#: f32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
#: f32 operations of one cycle of the symmetric step (flitsim
#: _symmetric_stepfn: adds, multiplies, divisions, min/max, floor)
SYM_STEP_OPS = 51
#: ... and of one access of the asymmetric step
ASYM_STEP_OPS = 6
DEV = torch.device("cuda")
F32 = torch.float32

SOURCES = {"symmetric_chunk": "src/repro_torch/csrc/flit_sim.cu",
           "asymmetric_periodic": "src/repro_torch/csrc/flit_sim.cu",
           "symmetric_periodic": "src/repro_torch/csrc/flit_sim.cu"}
REPLACES = {"symmetric_chunk": "src/repro/kernels/flit_sim/kernel.py:84",
            "asymmetric_periodic":
                "src/repro/kernels/flit_sim/kernel.py:105",
            "symmetric_periodic":
                "src/repro/kernels/flit_sim/kernel.py:127"}


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Progress line with the seconds since start, flushed at once."""
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def hold(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Fail unless ``got`` equals ``want`` bitwise; returns max |diff|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got - want).abs().max().item() \
            if got.shape == want.shape else float("nan")
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max |diff| {diff})")
    return float((got - want).abs().max().item())


# -- operands -----------------------------------------------------------------


def sym_rows(keys, fracs, backlogs) -> torch.Tensor:
    ps = flitsim.SymmetricFlitParams.stack(
        [flitsim.SYMMETRIC_PARAMS[k] for k in keys], DEV)
    x = torch.as_tensor(100.0 * np.asarray(fracs), dtype=F32, device=DEV)
    y = 100.0 - x
    return flitsim._sym_param_rows(
        ps, x, y, torch.as_tensor(backlogs, dtype=F32, device=DEV))


def asym_rows(fracs) -> torch.Tensor:
    ps = flitsim.AsymmetricLaneParams.stack(
        [flitsim.ASYMMETRIC_PARAMS[k] for k in flitsim.ASYMMETRIC_PARAMS],
        DEV)
    x = torch.as_tensor(100.0 * np.asarray(fracs), dtype=F32, device=DEV)
    return flitsim._asym_param_rows(ps, x, 100.0 - x)


def chunk_steps(params: torch.Tensor, horizon: int = 2048,
                chunk: int = 128):
    """The (state-independent) hist/scal builder of the adaptive loop, run
    with the plain version so that every chunk's inputs are known."""
    K = horizon // chunk
    K0 = max(K // 4, 1)
    min_k = max(4, K0 + 1)
    cells = params.shape[1]
    z = lambda r: torch.zeros((r, cells), dtype=F32, device=DEV)
    state = z(ref.SYM_ROWS)
    Dh, TDh, Ph = [z(1)], [z(1)], [z(5)]
    for k in range(1, K + 1):
        m = max(k - 4, (k + 1) // 2)
        mid = (m + k + 1) // 2
        hist = torch.cat([
            Ph[max(k - 3, 0)], Dh[m] if m < k else z(1),
            TDh[m] if m < k else z(1), Dh[mid] if mid < k else z(1),
            TDh[mid] if mid < k else z(1), Dh[K0] if k > K0 else z(1),
            z(6)])
        scal = flitsim._scal_row(
            [k, m, mid, K0, K, chunk, 1e-3,
             1.0 if (k >= min_k and k > 3) else 0.0,
             1.0 if k >= K else 0.0, 2.0], DEV)
        yield state, hist, scal
        state = ref.symmetric_chunk_compute(params, state, hist, scal,
                                            chunk=chunk)
        Dh.append(state[7:8])
        TDh.append(state[8:9])
        Ph.append(state[0:5])


# -- phase 3: each kernel against its plain version ---------------------------


def check_symmetric_chunk(params, reps):
    """All 16 chunks of a run, kernel vs plain on identical inputs; times
    the chunk of the middle of the run.  Returns (max_abs, ms, plain_ms,
    inputs of the timed chunk)."""
    err, timed = 0.0, None
    for k, (state, hist, scal) in enumerate(chunk_steps(params), 1):
        got = ops.symmetric_chunk(params, state, hist, scal, chunk=128)
        want = ref.symmetric_chunk_compute(params, state, hist, scal,
                                           chunk=128)
        err = max(err, hold(f"symmetric_chunk k={k}", got, want))
        if k == 8:
            timed = (state, hist, scal)
    state, hist, scal = timed
    ms = time_ms(lambda: ops.symmetric_chunk(params, state, hist, scal,
                                             chunk=128), reps)
    plain = time_ms(lambda: ref.symmetric_chunk_compute(
        params, state, hist, scal, chunk=128), max(reps // 5, 2))
    return err, ms, plain


def check_periodic(name, fn, plain_fn, params, reps):
    got = fn(params)
    want = plain_fn(params)
    err = hold(name, got, want)
    ms = time_ms(lambda: fn(params), reps)
    plain = time_ms(lambda: plain_fn(params), max(reps // 5, 2))
    return err, ms, plain, want


def bound_ms(bytes_moved: float, ops_done: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_done / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_shapes():
    """Operands of each kernel at the bridge's shapes and at ~2^20 cells
    (the catalog protocols over a dense read-fraction x backlog grid)."""
    keys = tuple(flitsim.SYMMETRIC_PARAMS)
    fr21 = np.linspace(0.0, 1.0, 21)
    return {
        "bridge": {
            "symmetric_chunk": sym_rows(keys, fr21, [2.0, 8.0, 64.0]),
            "asymmetric_periodic": asym_rows(fr21),
            "symmetric_periodic": sym_rows(keys, fr21, [1.0, 2.0, 4.0]),
        },
        "2^20 cells": {
            "symmetric_chunk": sym_rows(keys, np.linspace(0, 1, 2731),
                                        np.linspace(1.0, 128.0, 128)),
            "asymmetric_periodic": asym_rows(np.linspace(0, 1, 1 << 19)),
            "symmetric_periodic": sym_rows(keys, np.linspace(0, 1, 2731),
                                           np.linspace(0.25, 4.0, 128)),
        },
    }


def phase_kernels():
    """Every kernel against its plain version at the bridge's shapes and
    at ~2^20 cells; returns per-kernel records per shape."""
    asym = lambda p: ops.asymmetric_periodic(p, n_accesses=4096)
    asym_plain = lambda p: ref.asymmetric_periodic_compute(p,
                                                           n_accesses=4096)
    symp = lambda p: ops.symmetric_periodic(p, n_flits=2048)
    symp_plain = lambda p: ref.symmetric_periodic_compute(p, n_flits=2048)
    shapes = kernel_shapes()
    records = {}
    for label, ops_in in shapes.items():
        reps = 20 if label == "bridge" else 10
        p = ops_in["symmetric_chunk"]
        cells = p.shape[1]
        log(f"checking symmetric_chunk @ {label} ({cells} cells)")
        err, ms, plain = check_symmetric_chunk(p, reps)
        b, by = bound_ms(4.0 * (3 * ref.SYM_ROWS * cells + ref.SCAL_COLS
                                + ref.SYM_ROWS * cells),
                         cells * (128 * (SYM_STEP_OPS + 4) + 60))
        records.setdefault(label, {})["symmetric_chunk"] = dict(
            cells=cells, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b, bound_by=by)

        p = ops_in["asymmetric_periodic"]
        cells = p.shape[1]
        log(f"checking asymmetric_periodic @ {label} ({cells} cells)")
        err, ms, plain, out = check_periodic("asymmetric_periodic", asym,
                                             asym_plain, p, reps)
        # data-dependent detection work: the lag search stops at the
        # detected period (all PERIOD_MAX lags for undetected cells)
        lags = torch.where(out[1] > 0.5, out[2],
                           float(ref.PERIOD_MAX)).sum().item()
        b, by = bound_ms(4.0 * 2 * ref.ASYM_ROWS * cells,
                         cells * (ref.PERIOD_OBS * ASYM_STEP_OPS + 24)
                         + 3 * lags)
        records[label]["asymmetric_periodic"] = dict(
            cells=cells, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b, bound_by=by)

        p = ops_in["symmetric_periodic"]
        cells = p.shape[1]
        log(f"checking symmetric_periodic @ {label} ({cells} cells)")
        err, ms, plain, out = check_periodic("symmetric_periodic", symp,
                                             symp_plain, p, reps)
        lags = torch.where(out[1] > 0.5, out[2],
                           float(ref.PERIOD_MAX)).sum().item()
        b, by = bound_ms(4.0 * (ref.SYM_ROWS + ref.SYM_PERIODIC_ROWS)
                         * cells,
                         cells * (ref.SYM_PERIOD_OBS * SYM_STEP_OPS
                                  + 2 * ref.PERIOD_WINDOW + 40)
                         + 7 * lags)
        records[label]["symmetric_periodic"] = dict(
            cells=cells, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b, bound_by=by)
        for name, r in records[label].items():
            log(f"kernel {name} @ {label} ({r['cells']} cells): bitwise "
                  f"equal to plain; kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
    return records


# -- phase 4: the main path ---------------------------------------------------


def load_summarize():
    spec = importlib.util.spec_from_file_location(
        "design_space_summary", ROOT / "tools" / "design_space_summary.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.summarize


def phase_main_path():
    golden = json.loads(
        (ROOT / "experiments/golden/design_space_summary.json").read_text())
    summarize = load_summarize()
    log("main path: bridge on the card")
    ops.reset_launches()
    t0 = time.perf_counter()
    ds = bridge_mode(device="cuda", verbose=False)
    torch.cuda.synchronize()
    bridge_s = time.perf_counter() - t0
    bridge_counts = dict(ops.launches)
    got = summarize(ds)
    bad = [k for k in golden if k != "serving_frontier"
           and got.get(k) != golden[k]]
    if bad:
        raise AssertionError(f"bridge summary differs from the golden in "
                             f"sections {bad}")
    for name in ("asymmetric_periodic", "symmetric_chunk"):
        if bridge_counts[name] <= 0:
            raise AssertionError(f"the bridge never launched {name}")
    held = sorted(k for k in golden if k != "serving_frontier")
    log(f"main path: bridge on the card in {bridge_s:.2f} s, summary "
          f"equals the golden on {held}; launches {bridge_counts}")

    # shallow queues: the symmetric periodic detector's path
    fracs = np.linspace(0.0, 1.0, 21)
    ops.reset_launches()
    res = DesignSpace([axis("read_fraction", fracs),
                       axis("backlog", [1.0, 2.0, 4.0])], sim=ADAPTIVE_SIM,
                      device="cuda").evaluate(metrics=("sim_efficiency",))
    torch.cuda.synchronize()
    shallow_counts = dict(ops.launches)
    if shallow_counts["symmetric_periodic"] <= 0:
        raise AssertionError("the shallow-queue space never launched "
                             "symmetric_periodic")
    if not np.all(np.isfinite(res["sim_efficiency"].values)):
        raise AssertionError("non-finite simulated efficiency")
    rows = sym_rows(tuple(flitsim.SYMMETRIC_PARAMS), fracs, [1.0, 2.0, 4.0])
    out = ops.symmetric_periodic(rows, n_flits=2048)
    ps = flitsim.SymmetricFlitParams.stack(
        list(flitsim.SYMMETRIC_PARAMS.values()), DEV)
    x = torch.as_tensor(100.0 * fracs, dtype=F32, device=DEV)
    fixed = flitsim._symmetric_grid(
        ps, x, 100.0 - x, torch.tensor([1.0, 2.0, 4.0], device=DEV),
        n_flits=2048).reshape(-1)
    det = out[1] > 0.5
    if not torch.equal(out[0][det], fixed[det]):
        raise AssertionError("symmetric_periodic detected cells differ "
                             "from the fixed engine")
    log(f"shallow-queue space: launches {shallow_counts}; "
          f"{int(det.sum())} detected cells bitwise equal to the fixed "
          f"engine")
    return bridge_counts, shallow_counts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {secs} s (wall {time.perf_counter() - t0:.1f} s)")
    for name, text in _build.BUILD_LOG.items():
        log(f"ptxas [{name}]:\n{text.strip()}")

    records = phase_kernels()
    bridge_counts, shallow_counts = phase_main_path()

    big = records["2^20 cells"]
    kernels = []
    for name in ("asymmetric_periodic", "symmetric_periodic",
                 "symmetric_chunk"):
        r = big[name]
        launches = (shallow_counts if name == "symmetric_periodic"
                    else bridge_counts)[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"],
                               records["bridge"][name]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "cells": r["cells"],
            "bridge_ms": records["bridge"][name]["ms"],
            "bridge_plain_ms": records["bridge"][name]["plain_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
