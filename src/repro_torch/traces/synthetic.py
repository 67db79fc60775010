"""Synthetic serving traces — port of :mod:`repro.traces.synthetic`.

Replays a continuous-batching serving engine (fixed decode slots, FIFO
admission — the same lifecycle as
``repro_torch.serve.ServingEngine``) as a
pure-numpy queueing simulation over a model's
:class:`~repro_torch.traces.model_traffic.ModelTrafficSpec`, then compiles the
per-tick byte/backlog records into a :class:`TrafficTrace`.  No model is
built and no weights exist, so the tests can sweep full-size
architectures (the byte model needs only config shapes).

One tick is one decode step for every active slot.  Arrivals come from
:mod:`repro_torch.traces.arrival`; queue depth plus active sequences is the
recorded backlog, which is what makes the compiled trace QPS-sensitive:
past the service rate the queue (and the simulated flit backlog) grows,
and prefill admissions pull the read fraction down from the decode
stream's read-heavy steady state.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from repro_torch.traces.arrival import (bursty_arrivals, diurnal_arrivals,
                                  poisson_arrivals)
from repro_torch.traces.model_traffic import ModelTrafficSpec
from repro_torch.traces.trace import TrafficTrace

ARRIVALS = {
    "poisson": poisson_arrivals,
    "diurnal": diurnal_arrivals,
    "bursty": bursty_arrivals,
}


def synthetic_serving_trace(spec: ModelTrafficSpec, *, qps: float,
                            n_ticks: int = 384, n_phases: int = 6,
                            batch_slots: int = 32, prompt_len: int = 512,
                            decode_len: int = 128,
                            arrival: str = "diurnal", seed: int = 0,
                            name: Optional[str] = None) -> TrafficTrace:
    """Generate a phase-compiled trace for ``spec`` under ``qps``
    requests per tick.

    The queueing replay admits arrivals into ``batch_slots`` decode
    slots (prompt/decode lengths jittered around ``prompt_len`` /
    ``decode_len``), prices every prefill and decode step through the
    spec's byte model, and records per-tick read/write bytes plus the
    outstanding-request backlog.  ``arrival`` picks the process:
    ``"poisson"`` (stationary), ``"diurnal"`` (day/night swing) or
    ``"bursty"`` (flash crowds).
    """
    if arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival process {arrival!r}; choose "
                         f"from {sorted(ARRIVALS)}")
    if qps < 0:
        raise ValueError(f"qps must be >= 0, got {qps}")
    n_ticks = int(n_ticks)
    arrivals = ARRIVALS[arrival](qps, n_ticks, seed=seed)
    rng = np.random.default_rng(seed + 1)

    queue: deque = deque()          # pending prompt lengths
    positions = np.zeros(batch_slots, np.int64)      # context per slot
    remaining = np.zeros(batch_slots, np.int64)      # decode tokens left
    active = np.zeros(batch_slots, bool)

    read_b = np.zeros(n_ticks, np.float64)
    write_b = np.zeros(n_ticks, np.float64)
    backlog = np.zeros(n_ticks, np.float64)

    def jitter(mean: int) -> int:
        return max(int(rng.integers(max(mean // 2, 1),
                                    mean + mean // 2 + 1)), 1)

    for t in range(n_ticks):
        for _ in range(int(arrivals[t])):
            queue.append(jitter(prompt_len))
        # admit into free slots; prefill is the write burst
        for slot in np.flatnonzero(~active):
            if not queue:
                break
            plen = queue.popleft()
            r, w = spec.prefill_bytes(plen)
            read_b[t] += r
            write_b[t] += w
            positions[slot] = plen
            remaining[slot] = jitter(decode_len)
            active[slot] = True
        # decode one token for every active slot
        slots = np.flatnonzero(active)
        for slot in slots:
            r, w = spec.decode_bytes(int(positions[slot]))
            read_b[t] += r
            write_b[t] += w
            positions[slot] += 1
            remaining[slot] -= 1
            if remaining[slot] <= 0:
                active[slot] = False
        if slots.size:
            # weights stream once per tick, amortized over the batch
            read_b[t] += spec.weight_stream_bytes
        backlog[t] = len(queue) + slots.size

    label = name if name is not None else \
        f"{spec.name}@qps{qps:g}-{arrival}"
    return TrafficTrace.from_ticks(label, read_b, write_b, backlog,
                                   n_phases=n_phases)
