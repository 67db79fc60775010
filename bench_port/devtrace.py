"""A profiled slice of the window, read from ``torch.profiler``.

The slice runs from a step boundary to the window's close.  Its device
operations (kernels, copies and sets) come from the profiler's trace with
their times moved onto the host clock by one marker range entered when
the slice starts.  :func:`kind_of` sorts kernels by name (a copy of the
port's ``launch/profile_serve.py``); :func:`merged` merges the operations'
intervals, so the busy time counts overlapping kernels once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

MARKER = "bench_port.slice_start"


def kind_of(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd"
    if "rglru_scan_kernel" in name:
        return "rglru_scan"
    if "ssd_scan_" in name:               # every stage of the SSD scan
        return "ssd_scan"
    if any(s in name for s in ("gemm", "xmma", "nvjet", "cutlass",
                               "cublas")):
        return "matmul"
    if "copy_kernel" in name or name.startswith("memcpy"):
        return "cast/copy"
    return "other"


def merged(intervals: List[Tuple[float, float]], lo: float,
           hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class Slice:
    t0: float                                   # host clock, s
    t1: float
    ops: List[Tuple[str, float, float]]         # (name, start, end)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Tuple[float, float]]:
        return merged([(a, b) for _, a, b in self.ops], self.t0, self.t1)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s in self.by_name().items():
            out[kind_of(name)] = out.get(kind_of(name), 0.0) + s
        return out

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, cursor = [], self.t0
        for a, b in self.busy():
            if a > cursor:
                gaps.append((cursor, a))
            cursor = b
        if self.t1 > cursor:
            gaps.append((cursor, self.t1))
        return gaps


class Profiled:
    """``start()`` at a step boundary, ``stop()`` after the window."""

    def __init__(self):
        import torch
        self._torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = 0.0
        self._host_ns = 0

    def start(self) -> None:
        self.prof.__enter__()
        with self._torch.profiler.record_function(MARKER):
            self._host_ns = time.perf_counter_ns()
        self.t0 = self._host_ns / 1e9

    def stop(self) -> Slice:
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        marks = [e for e in events if e.name() == MARKER]
        if not marks:
            raise RuntimeError("the profile lost its slice marker")
        offset = marks[0].start_ns() - self._host_ns
        cuda = self._torch.autograd.DeviceType.CUDA
        ops = [(e.name(), (e.start_ns() - offset) / 1e9,
                (e.start_ns() + e.duration_ns() - offset) / 1e9)
               for e in events
               if e.device_type() == cuda and not e.is_user_annotation()]
        return Slice(self.t0, self.t1, ops)


def warm_up_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up) is paid in the set-up and not in the window."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        x = torch.zeros(8, device="cuda" if torch.cuda.is_available()
                        else "cpu")
        x.add_(1.0)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
