#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``).  Phases, each fatal
on failure:

1. card: print ``nvidia-smi``'s name and power limit;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernel vs plain: every kernel against its plain PyTorch version on the
   card, bitwise (``torch.equal``), with CUDA-event timings of both: the
   flit-simulator kernels at the design-space paths' shapes and at about
   2^20 cells, ``pack_flits`` at 64 and 2^20 lines with the unpack round
   trip;
4. main path, each path driven with the launch counts set to 0 just
   before it and read just after:

   a. the explorer's ``--bridge`` run on the card at full width, its
      summary held against ``experiments/golden/design_space_summary.json``
      (every section but the serving one; ``asymmetric_periodic``,
      ``symmetric_chunk``);
   b. a shallow-queue design space (backlogs 1, 2, 4 x 21 read
      fractions; ``symmetric_periodic``), its detected cells held bitwise
      against the fixed engine;
   c. the Fig-13 pipelining design space (k 1..8 x 2 link UIs x 3 device
      UIs; ``pipelining_chunk``) against the same space on the CPU and the
      card's fixed engine, and ``simulate_lpddr6_pipelining(4)`` = 1;
   d. the explorer's ``--sweep`` on the card against the CPU
      (``symmetric_chunk``, ``asymmetric_periodic``);
   e. the quickstart's values on the card against the CPU;
   f. the Fig 8/9 flit data path: 2^16 lines packed (``pack_flits``) and
      unpacked, every line, header and checksum back;

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

from repro_torch import _build, quickstart  # noqa: E402
from repro_torch.core import flitsim  # noqa: E402
from repro_torch.core.space import ADAPTIVE_SIM, DesignSpace, axis  # noqa: E402
from repro_torch.explorer import bridge_mode, sweep_mode  # noqa: E402
from repro_torch.kernels.flit_pack import ops as pack_ops  # noqa: E402
from repro_torch.kernels.flit_pack import ref as pack_ref  # noqa: E402
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
#: f32 operations of one line of the pipelining step as the kernel does it
#: (modulo 4, 8 compares and 8 selects to read the ready entry, max,
#: 2 adds, 8 selects to write it back, idx + 1)
PIPE_STEP_OPS = 32
#: rows of the pipelining chunk's operands that the function needs: params
#: 0-2, state 0-10 (ready table, link_free, idx, previous report), hist 0
#: (the T1 anchor), and the PIPE_ROWS rows it writes
PIPE_READ_ROWS = 3 + 11 + 1
#: ... and of its report / convergence epilogue
PIPE_REPORT_OPS = 20
DEV = torch.device("cuda")
F32 = torch.float32

SOURCES = {"symmetric_chunk": "src/repro_torch/csrc/flit_sim.cu",
           "asymmetric_periodic": "src/repro_torch/csrc/flit_sim.cu",
           "symmetric_periodic": "src/repro_torch/csrc/flit_sim.cu",
           "pipelining_chunk": "src/repro_torch/csrc/flit_sim.cu",
           "pack_flits": "src/repro_torch/csrc/flit_pack.cu"}
REPLACES = {"symmetric_chunk": "src/repro/kernels/flit_sim/kernel.py:84",
            "asymmetric_periodic":
                "src/repro/kernels/flit_sim/kernel.py:105",
            "symmetric_periodic":
                "src/repro/kernels/flit_sim/kernel.py:127",
            "pipelining_chunk":
                "src/repro/kernels/flit_sim/kernel.py:152",
            "pack_flits": "src/repro/kernels/flit_pack/kernel.py:66"}
#: the Fig-13 design space of the main path (48 cells)
FIG13_KS = tuple(range(1, 9))
FIG13_US = (8.0, 16.0)
FIG13_DS = (16.0, 32.0, 64.0)
#: lines of the flit data path on the main path
PACK_MAIN_LINES = 1 << 16


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


def close(name: str, got, want, atol: float) -> float:
    """Fail unless ``got`` is within ``atol`` of ``want`` everywhere;
    returns max |diff|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape} "
                             f"or non-finite values")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if err > atol:
        raise AssertionError(f"{name}: max |diff| {err} > {atol}")
    return err


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


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    ops.reset_launches()
    pack_ops.reset_launches()


def read_counts() -> dict:
    """Every kernel's launch count since :func:`reset_counts`."""
    return {**ops.launches, **pack_ops.launches}


def pipe_rows(ks, us, ds) -> torch.Tensor:
    return flitsim._pipe_param_rows(
        torch.as_tensor(ks, device=DEV),
        torch.as_tensor(us, dtype=F32, device=DEV),
        torch.as_tensor(ds, dtype=F32, device=DEV))


def pipe_steps(params: torch.Tensor, horizon: int = 512, chunk: int = 64):
    """The adaptive pipelining loop's per-chunk inputs (horizon 512, chunk
    64: the path's schedule), run with the plain version."""
    K = horizon // chunk
    cells = params.shape[1]
    state = torch.zeros((ref.PIPE_ROWS, cells), dtype=F32, device=DEV)
    hist = torch.zeros((ref.ASYM_ROWS, cells), dtype=F32, device=DEV)
    for k in range(1, K + 1):
        scal = flitsim._scal_row([k, K, chunk, 1e-3,
                                  1.0 if k >= min(4, K) else 0.0,
                                  1.0 if k >= K else 0.0, horizon], DEV)
        yield state, hist, scal
        state = ref.pipelining_chunk_compute(params, state, hist, scal,
                                             chunk=chunk)
        if k == 1:
            hist = torch.cat([state[8:9], torch.zeros(
                (ref.ASYM_ROWS - 1, cells), dtype=F32, device=DEV)])


def pack_inputs(n: int, seed: int):
    g = torch.Generator(device=DEV).manual_seed(seed)
    f = pack_ref.flits_needed(n)
    return [torch.randint(0, 256, shape, generator=g, device=DEV,
                          dtype=torch.int32)
            for shape in ((n, pack_ref.LINE_BYTES), (f, pack_ref.HS_BYTES),
                          (f, pack_ref.META_BYTES))]


def round_trip(name: str, flits, args) -> None:
    """Unpack ``flits`` and fail unless every line, header, meta byte and
    checksum comes back."""
    lines, headers, meta, ok = pack_ops.unpack(flits, args[0].shape[0])
    if not bool(ok.all()):
        raise AssertionError(f"{name}: {int((~ok).sum())} flits fail "
                             f"their checksum")
    for got, want in zip((lines, headers, meta), args):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: unpack does not return the "
                                 f"packed bytes")


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


def check_pipelining_chunk(params, reps):
    """All 8 chunks of a run, kernel vs plain on identical inputs; times
    chunk 4 (the first that may exit).  Returns (max_abs, ms, plain_ms)."""
    err, timed = 0.0, None
    for k, (state, hist, scal) in enumerate(pipe_steps(params), 1):
        got = ops.pipelining_chunk(params, state, hist, scal, chunk=64)
        want = ref.pipelining_chunk_compute(params, state, hist, scal,
                                            chunk=64)
        err = max(err, hold(f"pipelining_chunk k={k}", got, want))
        if k == 4:
            timed = (state, hist, scal)
    state, hist, scal = timed
    ms = time_ms(lambda: ops.pipelining_chunk(params, state, hist, scal,
                                              chunk=64), reps)
    plain = time_ms(lambda: ref.pipelining_chunk_compute(
        params, state, hist, scal, chunk=64), max(reps // 5, 2))
    return err, ms, plain


def check_pack(n: int, reps: int):
    """``pack_flits`` vs ``pack_flits_ref`` on ``n`` random lines, then the
    round trip.  Returns (max_abs, ms, plain_ms, flits)."""
    args = pack_inputs(n, seed=n)
    got = pack_ops.pack(*args)
    err = hold(f"pack_flits n={n}", got, pack_ref.pack_flits_ref(*args))
    round_trip(f"pack_flits n={n}", got, args)
    ms = time_ms(lambda: pack_ops.pack(*args), reps)
    plain = time_ms(lambda: pack_ref.pack_flits_ref(*args),
                    max(reps // 5, 2))
    return err, ms, plain, got.shape[0]


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
    """Operands of each kernel at its main-path shapes (the bridge's grids,
    the Fig-13 space, the flit data path's lines) and at ~2^20 cells (the catalog protocols
    over a dense read-fraction x backlog grid; k 1..8 x 128 link UIs x
    1024 device UIs; 2^20 lines)."""
    keys = tuple(flitsim.SYMMETRIC_PARAMS)
    fr21 = np.linspace(0.0, 1.0, 21)
    return {
        "path": {
            "symmetric_chunk": sym_rows(keys, fr21, [2.0, 8.0, 64.0]),
            "asymmetric_periodic": asym_rows(fr21),
            "symmetric_periodic": sym_rows(keys, fr21, [1.0, 2.0, 4.0]),
            "pipelining_chunk": pipe_rows(FIG13_KS, FIG13_US, FIG13_DS),
            "pack_flits": PACK_MAIN_LINES,
        },
        "2^20 cells": {
            "symmetric_chunk": sym_rows(keys, np.linspace(0, 1, 2731),
                                        np.linspace(1.0, 128.0, 128)),
            "asymmetric_periodic": asym_rows(np.linspace(0, 1, 1 << 19)),
            "symmetric_periodic": sym_rows(keys, np.linspace(0, 1, 2731),
                                           np.linspace(0.25, 4.0, 128)),
            "pipelining_chunk": pipe_rows(FIG13_KS,
                                          np.linspace(4.0, 32.0, 128),
                                          np.linspace(8.0, 256.0, 1024)),
            "pack_flits": 1 << 20,
        },
    }


def phase_kernels():
    """Every kernel against its plain version at its main-path shapes and
    at ~2^20 cells; returns per-kernel records per shape."""
    asym = lambda p: ops.asymmetric_periodic(p, n_accesses=4096)
    asym_plain = lambda p: ref.asymmetric_periodic_compute(p,
                                                           n_accesses=4096)
    symp = lambda p: ops.symmetric_periodic(p, n_flits=2048)
    symp_plain = lambda p: ref.symmetric_periodic_compute(p, n_flits=2048)
    shapes = kernel_shapes()
    records = {}
    for label, ops_in in shapes.items():
        reps = 20 if label == "path" else 10
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

        p = ops_in["pipelining_chunk"]
        cells = p.shape[1]
        log(f"checking pipelining_chunk @ {label} ({cells} cells)")
        err, ms, plain = check_pipelining_chunk(p, reps)
        b, by = bound_ms(4.0 * ((PIPE_READ_ROWS + ref.PIPE_ROWS) * cells
                                + ref.SCAL_COLS),
                         cells * (64 * PIPE_STEP_OPS + PIPE_REPORT_OPS))
        records[label]["pipelining_chunk"] = dict(
            cells=cells, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b, bound_by=by)

        if label == "path":
            err, ms, plain, flits = check_pack(64, reps)
            log(f"kernel pack_flits @ 64 lines ({flits} flits): bitwise "
                f"equal to plain, round trip good; kernel {ms:.4f} ms, "
                f"plain {plain:.3f} ms")
        n = ops_in["pack_flits"]
        log(f"checking pack_flits @ {label} ({n} lines)")
        err, ms, plain, flits = check_pack(n, reps)
        # bytes: every line, header and meta word read once, every flit
        # word written once; operations: one XOR per checksummed byte
        b, by = bound_ms(4.0 * (pack_ref.LINE_BYTES * n
                                + (pack_ref.HS_BYTES + pack_ref.META_BYTES
                                   + pack_ref.FLIT_BYTES) * flits),
                         pack_ref.BODY_BYTES * flits)
        records[label]["pack_flits"] = dict(
            cells=n, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
            bound_by=by)
        for name, r in records[label].items():
            log(f"kernel {name} @ {label} ({r['cells']} cells/lines): bitwise "
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
    reset_counts()
    t0 = time.perf_counter()
    ds = bridge_mode(device="cuda", verbose=False)
    torch.cuda.synchronize()
    bridge_s = time.perf_counter() - t0
    bridge_counts = read_counts()
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
    reset_counts()
    res = DesignSpace([axis("read_fraction", fracs),
                       axis("backlog", [1.0, 2.0, 4.0])], sim=ADAPTIVE_SIM,
                      device="cuda").evaluate(metrics=("sim_efficiency",))
    torch.cuda.synchronize()
    shallow_counts = read_counts()
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
    return {"bridge": bridge_counts, "shallow": shallow_counts,
            "fig13": phase_fig13(), "sweep": phase_sweep(),
            "quickstart": phase_quickstart(), "flit_pack": phase_flit_pack()}


def phase_fig13():
    """The Fig-13 pipelining space on the card (adaptive: the fused
    ``pipelining_chunk`` loop) against the CPU and the fixed engine."""
    axes = [axis("k", FIG13_KS), axis("ucie_line_ui", FIG13_US),
            axis("device_line_ui", FIG13_DS)]
    log("main path: Fig-13 pipelining space on the card")
    reset_counts()
    t0 = time.perf_counter()
    res = DesignSpace(axes, sim=ADAPTIVE_SIM, device="cuda").evaluate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n = counts["pipelining_chunk"]
    if not 0 < n <= 8:
        raise AssertionError(f"the Fig-13 space launched pipelining_chunk "
                             f"{n} times (want 1..8)")
    util = res["utilization"].values
    cpu = DesignSpace(axes, sim=ADAPTIVE_SIM, device="cpu").evaluate()
    err_cpu = close("Fig-13 card vs CPU", util,
                    cpu["utilization"].values, 1e-6)
    fixed = DesignSpace(axes, device="cuda").evaluate()
    err_fixed = close("Fig-13 adaptive vs fixed", util,
                      fixed["utilization"].values, 1e-3)
    u4 = flitsim.simulate_lpddr6_pipelining(4, device="cuda")
    close("simulate_lpddr6_pipelining(4)", [u4], [1.0], 1e-3)
    sat = {}
    for a, u in enumerate(FIG13_US):
        for b, d in enumerate(FIG13_DS):
            ok = np.flatnonzero(util[:, a, b] >= 1.0 - 1e-3)
            sat[f"u={u:g},d={d:g}"] = int(FIG13_KS[ok[0]]) if ok.size \
                else None
    log(f"main path: Fig-13 space in {wall:.3f} s, launches {counts}; "
        f"card vs CPU max |diff| {err_cpu}, vs fixed {err_fixed}; "
        f"simulate_lpddr6_pipelining(4) = {u4}; smallest saturating k "
        f"per (ucie_line_ui, device_line_ui): {sat}")
    return counts


def phase_sweep():
    """The explorer's ``--sweep`` on the card against the CPU."""
    log("main path: --sweep on the card")
    reset_counts()
    t0 = time.perf_counter()
    card = sweep_mode(device="cuda", verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for name in ("symmetric_chunk", "asymmetric_periodic"):
        if counts[name] <= 0:
            raise AssertionError(f"the sweep never launched {name}")
    cpu = sweep_mode(device="cpu", verbose=False)
    for key in ("regimes", "catalog_regimes", "protocols"):
        if card[key] != cpu[key]:
            raise AssertionError(f"sweep {key} differ between the card and "
                                 f"the CPU")
    err = close("sweep efficiency card vs CPU", card["efficiency"],
                cpu["efficiency"], 1e-6)
    engines = {fam: {k: info[k] for k in ("engine", "launches",
                                          "stragglers", "elapsed_s")}
               for fam, info in card["run_info"].items()
               if fam != "flitsim.pipelining"}
    log(f"main path: --sweep on the card in {wall:.3f} s (simulated part "
        f"{card['sim_s']:.3f} s; engines {engines}), launches {counts}; "
        f"regimes equal to the CPU run, efficiency max |diff| {err}; "
        f"backlog-64 regimes {card['regimes']}")
    return counts


def _flat(q) -> list:
    """Every number of a quickstart result, in a fixed order."""
    out = []
    for key in ("linear_density", "pj_per_bit"):
        for vals in q[key].values():
            out += vals
    out += list(q["bus_density"].values())
    out += list(q["latency_speedup"].values())
    for r in q["sim_vs_analytic"].values():
        out += [r["analytic"], r["simulated"]]
    out += [r["bandwidth_gbs"] for r in q["ranking"]]
    out.append(q["best"]["gbs_per_watt"])
    return out


def phase_quickstart():
    log("main path: quickstart on the card")
    reset_counts()
    t0 = time.perf_counter()
    card = quickstart.collect("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    cpu = quickstart.collect("cpu")
    if [r["key"] for r in card["ranking"]] != \
            [r["key"] for r in cpu["ranking"]] or \
            card["best"]["key"] != cpu["best"]["key"]:
        raise AssertionError("quickstart ranking differs between the card "
                             "and the CPU")
    err = close("quickstart card vs CPU", _flat(card), _flat(cpu), 1e-6)
    log(f"main path: quickstart on the card in {wall:.3f} s, launches "
        f"{counts}; values max |diff| vs CPU {err}; best "
        f"{card['best']['key']}")
    return counts


def phase_flit_pack():
    log(f"main path: flit data path, {PACK_MAIN_LINES} lines")
    args = pack_inputs(PACK_MAIN_LINES, seed=1)
    reset_counts()
    t0 = time.perf_counter()
    flits = pack_ops.pack(*args)
    round_trip("flit data path", flits, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    hold("flit data path", flits, pack_ref.pack_flits_ref(*args))
    if counts["pack_flits"] <= 0:
        raise AssertionError("the flit data path never launched pack_flits")
    log(f"main path: {flits.shape[0]} flits packed and unpacked in "
        f"{wall:.4f} s, bitwise equal to the plain version, every checksum "
        f"good; launches {counts}")
    return counts


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
    counts = phase_main_path()

    big = records["2^20 cells"]
    #: the main-path run each kernel's launch count is read from
    path_of = {"asymmetric_periodic": "bridge", "symmetric_chunk": "bridge",
               "symmetric_periodic": "shallow", "pipelining_chunk": "fig13",
               "pack_flits": "flit_pack"}
    kernels = []
    for name in ("asymmetric_periodic", "symmetric_periodic",
                 "symmetric_chunk", "pipelining_chunk", "pack_flits"):
        r = big[name]
        launches = counts[path_of[name]][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"],
                               records["path"][name]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "cells": r["cells"],
            "path_cells": records["path"][name]["cells"],
            "path_ms": records["path"][name]["ms"],
            "path_plain_ms": records["path"][name]["plain_ms"],
            "path_bound_ms": records["path"][name]["bound_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
