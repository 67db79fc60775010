"""One run of one cell: set-up, the window, the metrics, the check.

:func:`execute` is what ``run.py`` runs on the card; the CPU tests run it
at a reduced configuration with ``device="cpu"``.  The order is the
contract's: the set-up (the port's CUDA libraries built where this
checkout lacks them, timed apart as ``build_s`` too; weights; the two
extreme prompt lengths of the mix prefilled once; the loop's ramp) counts
as ``setup_s``; the window is timed; ``memory_peak_bytes`` is read; the
engine and its caches are freed; then the sampled requests are checked
against the reference.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
from typing import Any, Dict, List, Optional

from bench_port import check, devtrace, spec
from bench_port.loop import ClosedLoop, Recorder, Step, Window, clock, \
    window_of
from bench_port.traffic.generator import Stream
from bench_port.weights import make_weights

METRICS_DIR = spec.BENCH_DIR / "metrics"
TOP = 10


@dataclasses.dataclass
class RunView:
    """What a metric reader (``metrics/<name>.py``) is handed."""
    cell: spec.Cell
    cfg: Any                          # the port's ModelConfig
    setup_s: float
    window: Window
    slice: Optional[devtrace.Slice]   # traced runs only
    slice_steps: List[Step]


def read_metric(name: str, run: RunView) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(run)``: a number, or ``None`` where
    it finds nothing to read."""
    path = METRICS_DIR / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    value = mod.read(run)
    return None if value is None else float(value)


def _phase_at(t: float, steps: List[Step]) -> str:
    for i, s in enumerate(steps):
        for a, b, name in s.phases():
            if a <= t <= b:
                return name
        if i + 1 < len(steps) and s.t_end <= t <= steps[i + 1].t_start:
            return "between_steps"
    return "outside_steps"


def breakdown(sl: devtrace.Slice, steps: List[Step]) -> Dict[str, list]:
    """The device operations that took most time (``kind: kernel``) and
    the longest idle gaps, each named by the host's phase at its middle."""
    ops = sorted(sl.by_name().items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(sl.idle_gaps(), key=lambda g: g[0] - g[1])[:TOP]
    return {
        "device_ops": [[f"{devtrace.kind_of(n)}: {n[:120]}", s]
                       for n, s in ops],
        "idle_gaps": [[_phase_at((a + b) / 2, steps), b - a]
                      for a, b in gaps],
    }


def _warm_up_prefills(model, weights, cell, device) -> None:
    import torch
    for n in (cell.traffic["prompt"]["min"], cell.traffic["prompt"]["max"]):
        toks = torch.zeros((1, n), dtype=torch.long, device=device)
        model.prefill(weights, toks, pad_cache_to=cell.max_len)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Served:
    """A cell served through its window, before the check."""
    device: Any
    cfg: Any
    weights: Dict[str, Any]
    loop: ClosedLoop
    setup_s: float
    build_s: float
    window: Window
    slice: Optional[devtrace.Slice]
    memory_peak_bytes: int


def serve(cell: spec.Cell, seed: int, seconds: float, trace: bool,
          device, t_start: float) -> Served:
    """Set up ``cell`` from ``seed`` and run its window (profiling its
    last ``trace_slice_s`` seconds where ``trace``)."""
    import torch
    from repro_torch.models import build
    from repro_torch.serve.engine import ServingEngine

    build_s = build_kernels() if device.type == "cuda" else 0.0
    cfg = spec.model_config(cell.config)
    model = build(cfg)
    weights = make_weights(model, seed, device, cell.config.get("init"))
    _warm_up_prefills(model, weights, cell, device)
    if trace:
        devtrace.warm_up_profiler()
    engine = ServingEngine(model, weights, batch_slots=cell.batch_slots,
                           max_len=cell.max_len, recorder=Recorder(),
                           device=device)
    loop = ClosedLoop(engine, Stream(cell.traffic, seed, cell.clients,
                                     cfg.vocab_size), cell.clients)
    loop.ramp()
    setup_s = clock() - t_start

    prof = devtrace.Profiled() if trace else None
    slice_from = max(0.0, seconds - float(cell.workload["trace_slice_s"]))
    started = []

    def on_step(elapsed: float) -> None:
        if prof is not None and not started and elapsed >= slice_from:
            prof.start()
            started.append(elapsed)

    if slice_from == 0.0:
        on_step(0.0)
    t_open, t_close = loop.run(seconds, on_step)
    sl = prof.stop() if started else None
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    return Served(device, cfg, weights, loop, setup_s, build_s,
                  window_of(loop, t_open, t_close), sl, peak)


def build_kernels() -> float:
    """Build the port's CUDA libraries that this checkout has not built
    yet (``nvcc``, into ``build/`` inside the checkout) -> the seconds it
    took: part of ``setup_s``, and reported apart as ``build_s``."""
    from repro_torch import _build
    t0 = clock()
    _build.build()
    return clock() - t0


def free_engine(served: Served) -> None:
    """Drop the engine and its caches (the weights stay: they are the
    benchmark's, and the reference reads them)."""
    import torch
    served.loop.engine = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(cell: spec.Cell, served: Served, seed: int,
             precisions=()) -> tuple:
    """The check's sample of the requests ``served`` finished in its
    window (drawn from ``seed``), read once the engine is freed ->
    (the sample, its :func:`check.gaps` in f32 and in ``precisions``)."""
    chosen = check.sample(served.window.finished(),
                          int(cell.workload["check"]["requests"]), seed)
    free_engine(served)
    return chosen, check.gaps(cell.config, served.weights, chosen,
                              served.device, precisions)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device="cuda", t_start: Optional[float] = None
            ) -> Dict[str, Any]:
    """Run ``cell`` once -> the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``trace`` a
    ``breakdown``; ``window``, the window's and the profiled slice's
    output tokens, for the tracing's cost; and ``checks`` last)."""
    import torch
    device = torch.device(device)
    t_start = clock() if t_start is None else t_start
    sv = serve(cell, seed, seconds, trace, device, t_start)
    window, sl = sv.window, sv.slice
    slice_steps = [] if sl is None else [
        s for s in window.steps if s.t_start >= sl.t0 and s.t_end <= sl.t1]
    view = RunView(cell, sv.cfg, sv.setup_s, window, sl, slice_steps)
    metrics = {}
    for m in cell.metrics(trace):
        value = read_metric(m["name"], view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    chosen, g = readings(cell, sv, seed)
    checks, failed = check.judge(cell, chosen, g)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": sv.memory_peak_bytes}
    out: Dict[str, Any] = {
        "correct": check.passed(checks),
        "attempted": int(window.ttft_s().size),
        "failed": failed, "metrics": metrics, "device": dev,
        "build_s": sv.build_s}
    toks = window.token_times()
    out["window"] = {"seconds": window.seconds,
                     "output_tokens": int(toks.size),
                     "finished": len(window.finished())}
    if sl is not None:
        out["window"]["slice_output_tokens"] = int(
            ((toks >= sl.t0) & (toks <= sl.t1)).sum())
    if trace:
        dev["busy_s"] = sl.busy_s() if sl is not None else 0.0
        dev["window_s"] = sl.seconds if sl is not None else 0.0
        if sl is not None:
            out["breakdown"] = breakdown(sl, slice_steps)
    out["checks"] = checks
    return out
