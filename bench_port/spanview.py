"""The port's own spans and counters (``repro_torch.runtime.spans``) over
a traced run's profiled slice, for the readers of the span and counter
metrics.

The port records them while ``torch.profiler`` runs, so a traced run's
recording period is its profiled slice, on the host clock the slice is on
(``time.perf_counter``).  :func:`load` keeps the spans whose interval lies
inside the slice; the counters are the period's.  A port without the
module, an untraced run and a slice with no span give ``None``: every
reader then returns ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


@dataclasses.dataclass
class Spans:
    names: List[str]                  # every record of the period
    t0: List[float]                   # host clock, s
    t1: List[Optional[float]]
    parent: List[int]
    rid: List[Optional[int]]
    n: List[Optional[int]]
    inside: List[int]                 # the records inside the slice
    counters: Dict[str, float]

    def named(self, *names: str) -> List[int]:
        """The records inside the slice with one of ``names``."""
        return [i for i in self.inside if self.names[i] in names]

    def intervals(self, *names: str) -> List[Interval]:
        return [(self.t0[i], self.t1[i]) for i in self.named(*names)]

    def under(self, i: int, name: str) -> bool:
        """Whether record ``i`` lies in a span called ``name``."""
        i = self.parent[i]
        while i >= 0:
            if self.names[i] == name:
                return True
            i = self.parent[i]
        return False


def load(run) -> Optional[Spans]:
    """The port's spans and counters of ``run``'s slice, or ``None``."""
    if run.slice is None:
        return None
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    lo, hi = run.slice.t0, run.slice.t1
    recs = snap.spans
    t0 = [r.t0_ns / 1e9 for r in recs]
    t1 = [None if r.t1_ns is None else r.t1_ns / 1e9 for r in recs]
    inside = [i for i in range(len(recs))
              if t1[i] is not None and lo <= t0[i] and t1[i] <= hi]
    if not inside:
        return None
    return Spans([r.name for r in recs], t0, t1, [r.parent for r in recs],
                 [r.rid for r in recs], [r.n for r in recs], inside,
                 dict(snap.counters))


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering ``intervals``."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """The intersection of two unions (each sorted and disjoint)."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """``xs`` less ``ys`` (each sorted and disjoint)."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            c, d = ys[k]
            if c > a:
                out.append((a, c))
            a = max(a, d)
            k += 1
        if a < b:
            out.append((a, b))
    return out


def length(xs: Iterable[Interval]) -> float:
    return sum(b - a for a, b in xs)


MODEL = ("model.prefill", "model.decode_step")


def idle_split(run, v: Spans) -> Dict[str, float]:
    """The slice's idle time (no device operation) in s, split by where
    the host was: inside a model call, inside ``engine.step`` but outside
    any model call, and outside the engine."""
    idle = run.slice.idle_gaps()
    model = union(v.intervals(*MODEL))
    engine = subtract(union(v.intervals("engine.step")), model)
    rest = subtract(subtract(idle, model), engine)
    return {"model": length(intersect(idle, model)),
            "engine": length(intersect(idle, engine)),
            "outside": length(rest)}


def slice_tokens(run) -> int:
    """Output tokens returned inside the slice."""
    toks = run.window.token_times()
    return int(((toks >= run.slice.t0) & (toks <= run.slice.t1)).sum())


def mb_per_token(run, *counters: str) -> Optional[float]:
    """The bytes of ``counters`` in the slice, in MB (1e6 bytes), over
    its output tokens."""
    v = load(run)
    if v is None or not any(c in v.counters for c in counters):
        return None
    toks = slice_tokens(run)
    if toks == 0:
        return None
    return sum(v.counters.get(c, 0.0) for c in counters) / 1e6 / toks
