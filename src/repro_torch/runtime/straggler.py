"""Straggler mitigation: per-step latency monitoring + mitigation hooks.

At multi-pod scale the dominant availability hazards are slow hosts (NIC
degradation, thermal throttle) rather than hard failures.  The monitor
keeps an EWMA + robust deviation of step times; a step slower than
``threshold``x the EWMA flags a straggler event.  Mitigation is pluggable:
the default action logs and (after ``evict_after`` consecutive events)
requests a remap — in a real deployment that triggers the elastic
restart path onto the healthy device set (checkpoint -> remap -> resume);
here it is observable through the report and tested with synthetic
latency injection.  (Port of :mod:`repro.runtime.straggler`: ``timed``
synchronizes the card where the reference blocks on its arrays.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    ewma_s: float


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    alpha: float = 0.1
    evict_after: int = 3
    on_remap: Optional[Callable[[int], None]] = None

    ewma: Optional[float] = None
    consecutive: int = 0
    events: List[StragglerEvent] = dataclasses.field(default_factory=list)
    remaps: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, duration_s: float) -> bool:
        """Record a step time; returns True if flagged as straggler."""
        if self.ewma is None:
            self.ewma = duration_s
            return False
        flagged = duration_s > self.threshold * self.ewma
        if flagged:
            self.events.append(StragglerEvent(step, duration_s, self.ewma))
            self.consecutive += 1
            if self.consecutive >= self.evict_after:
                self.remaps.append(step)
                self.consecutive = 0
                if self.on_remap is not None:
                    self.on_remap(step)
        else:
            self.consecutive = 0
            # only fold healthy steps into the baseline
            self.ewma = (1 - self.alpha) * self.ewma \
                + self.alpha * duration_s
        return flagged

    def timed(self, fn):
        """Wrap a step function with timing + observation; the wrapped
        function's first argument is the step index.  The card (if any)
        is synchronized before the clock is read, so the time is the
        step's and not its enqueue's."""
        import torch

        def wrapper(step, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.observe(step, time.perf_counter() - t0)
            return out
        return wrapper
