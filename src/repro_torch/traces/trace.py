"""Phase-compiled traffic traces — port of :mod:`repro.traces.trace`.

A :class:`TrafficTrace` is a short sequence of traffic *phases*, each a
``(duration, read_fraction, backlog)`` triple:

* ``duration`` — how long the phase lasted, in engine ticks (used as the
  aggregation weight; the simulators sample every phase for the same
  static cycle count so one executable serves every trace of a given
  phase count).
* ``read_fraction`` — the phase's byte-weighted read share in ``[0, 1]``
  (lowered to the simulators' ``x:y`` mix as ``100*rf : 100-100*rf``).
* ``backlog`` — mean outstanding requests during the phase (> 0), the
  symmetric simulators' queue-pressure knob.

Traces are compiled from per-tick records (:meth:`TrafficTrace.from_ticks`
— what the serving recorder and the synthetic generator both emit) and
evaluated by the flit simulators in trace-scan mode: phases run back to
back and the queue/credit state is CARRIED across phase boundaries, so
the backlog transient at a prefill-burst -> decode-stream edge is
simulated rather than reset (see ``flitsim.simulate_trace_grid``).

This module is numpy + stdlib only: a trace is a plain frozen dataclass
over tuples, and the trace tests need no model weights.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

#: floor for compiled phase backlogs: a drained engine still has the
#: probe request in flight, and the flit cores need backlog > 0
MIN_BACKLOG = 1.0


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """A named sequence of (duration, read_fraction, backlog) phases."""

    name: str
    durations: Tuple[float, ...]
    read_fractions: Tuple[float, ...]
    backlogs: Tuple[float, ...]

    def __post_init__(self):
        n = len(self.durations)
        if n < 1:
            raise ValueError(f"trace {self.name!r} needs >= 1 phase")
        if len(self.read_fractions) != n or len(self.backlogs) != n:
            raise ValueError(
                f"trace {self.name!r}: phase arrays disagree on length "
                f"({n} durations, {len(self.read_fractions)} read "
                f"fractions, {len(self.backlogs)} backlogs)")
        object.__setattr__(self, "durations",
                           tuple(float(d) for d in self.durations))
        object.__setattr__(self, "read_fractions",
                           tuple(float(r) for r in self.read_fractions))
        object.__setattr__(self, "backlogs",
                           tuple(float(b) for b in self.backlogs))
        if any(d < 0.0 for d in self.durations) or \
                not sum(self.durations) > 0.0:
            raise ValueError(f"trace {self.name!r}: durations must be "
                             f">= 0 with a positive sum, got "
                             f"{self.durations}")
        for r in self.read_fractions:
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"trace {self.name!r}: read fraction {r} "
                                 "outside [0, 1]")
        for b in self.backlogs:
            if not b > 0.0:
                raise ValueError(f"trace {self.name!r}: backlog {b} must "
                                 "be > 0")

    @property
    def n_phases(self) -> int:
        return len(self.durations)

    def padded(self, n: int) -> "TrafficTrace":
        """Extend to ``n`` phases by repeating the last phase with zero
        duration — zero-weight padding changes no aggregate, so traces of
        different lengths can share one axis (and one executable)."""
        if n < self.n_phases:
            raise ValueError(f"cannot pad trace {self.name!r} of "
                             f"{self.n_phases} phases down to {n}")
        if n == self.n_phases:
            return self
        pad = n - self.n_phases
        return TrafficTrace(
            name=self.name,
            durations=self.durations + (0.0,) * pad,
            read_fractions=(self.read_fractions
                            + (self.read_fractions[-1],) * pad),
            backlogs=self.backlogs + (self.backlogs[-1],) * pad)

    @classmethod
    def steady(cls, name: str, read_fraction: float,
               backlog: float) -> "TrafficTrace":
        """Single-phase trace — bit-identical under the trace engine to
        the equivalent static (mix, backlog) cell."""
        return cls(name=name, durations=(1.0,),
                   read_fractions=(float(read_fraction),),
                   backlogs=(float(backlog),))

    @classmethod
    def from_ticks(cls, name: str, read_bytes: Sequence[float],
                   write_bytes: Sequence[float],
                   backlogs: Sequence[float],
                   n_phases: int = 8) -> "TrafficTrace":
        """Compile per-tick byte/backlog records into ``n_phases``
        contiguous phases (fewer if the record is shorter).

        Each phase covers an equal slice of ticks; its read fraction is
        the slice's byte-weighted read share (idle slices inherit the
        whole record's share) and its backlog is the slice mean, floored
        at :data:`MIN_BACKLOG`.
        """
        r = np.asarray(read_bytes, np.float64).reshape(-1)
        w = np.asarray(write_bytes, np.float64).reshape(-1)
        b = np.asarray(backlogs, np.float64).reshape(-1)
        if not (r.size == w.size == b.size) or r.size == 0:
            raise ValueError(
                f"trace {name!r}: per-tick records disagree on length "
                f"({r.size} read, {w.size} write, {b.size} backlog)")
        if n_phases < 1:
            raise ValueError(f"n_phases must be >= 1, got {n_phases}")
        n_phases = min(int(n_phases), r.size)
        tot_r, tot_w = float(r.sum()), float(w.sum())
        if tot_r + tot_w <= 0.0:
            raise ValueError(f"trace {name!r}: no bytes recorded")
        global_rf = tot_r / (tot_r + tot_w)
        durs, rfs, bls = [], [], []
        for rs, ws, bs in zip(np.array_split(r, n_phases),
                              np.array_split(w, n_phases),
                              np.array_split(b, n_phases)):
            seg = float(rs.sum() + ws.sum())
            durs.append(float(rs.size))
            rfs.append(float(rs.sum()) / seg if seg > 0.0 else global_rf)
            bls.append(max(float(bs.mean()), MIN_BACKLOG))
        return cls(name=name, durations=tuple(durs),
                   read_fractions=tuple(rfs), backlogs=tuple(bls))


def pad_traces(traces: Sequence[TrafficTrace]) -> Tuple[TrafficTrace, ...]:
    """Pad a collection to a common phase count (the max) so they can
    share one ``trace`` axis and one compiled executable."""
    if not traces:
        raise ValueError("need at least one trace")
    n = max(t.n_phases for t in traces)
    return tuple(t.padded(n) for t in traces)

