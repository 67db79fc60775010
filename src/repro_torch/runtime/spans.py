"""Spans and counters of the port's serving path, on the host clock.

``span(name, rid=None, n=None)`` marks a stretch of host code, ``mark``
a point, ``add`` and ``add_device`` count.  They record only while
recording is on: while a ``torch.profiler`` profile is active (the
benchmark's traced slice, an operator's ``export_chrome_trace``), or
inside :func:`recording`.  Off, a site costs one C check
(``torch._C._autograd._profiler_enabled()``): :func:`span` returns one
shared null context, allocates nothing and launches nothing.

On, a span appends ``(name, t0_ns, t1_ns, parent, rid, n)`` to a bounded
buffer (``LIMIT`` records; past it they are counted in ``dropped``), on
``time.perf_counter_ns``, the clock ``bench_port``'s device trace is
mapped onto; ``parent`` is the index of the innermost open span (-1 at the
top).  Under a profiler the span is also a ``record_function`` range, so
chrome traces show it.

A recording period starts at :func:`recording` or, under a profiler, at
the first site that finds recording on.  It empties the buffer and the
counters, so a snapshot holds one period (the benchmark's profiled
slice), and it counts the host's hidden synchronisations with the card:
it sets ``torch.cuda.set_sync_debug_mode("warn")`` and takes each "called
a synchronizing CUDA operation" warning (without printing it) as one
``sync.<innermost open span>`` count (``sync.outside`` with no span open)
and one ``sync`` mark under that span.  The period ends, and the previous
mode and warning hook come back, at the first site that finds recording
off, at the end of :func:`recording` or at :func:`snapshot`.

Counters: ``add(name, k)`` on the host; ``add_device(name, t)`` a running
f64 sum on ``t``'s device, with no sync.  :func:`snapshot` reads the
device sums once and returns them with the host counts.  The engine is one
Python thread; so is this module's state.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch

LIMIT = 1 << 20
SYNC = "sync"
SYNC_WARNING = "called a synchronizing CUDA operation"

_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: Optional[int]        # None while the span is open
    parent: int                 # index of the enclosing span, -1 at the top
    rid: Optional[int]
    n: Optional[int]


class Snapshot(NamedTuple):
    spans: List[Span]
    counters: Dict[str, float]
    dropped: int                # records past LIMIT, not stored


_records: List[list] = []       # [name, t0_ns, t1_ns, parent, rid, n]
_stack: List[int] = []          # indices of the open spans
_counts: Dict[str, float] = {}
_device: Dict[str, torch.Tensor] = {}
_dropped = 0
_generation = 0                 # bumped by clear(): open spans forget
_recording = 0                  # depth of recording() contexts
_live = False                   # inside a recording period
_saved: dict = {}


def on() -> bool:
    """Whether sites record now; switches the sync counting to match."""
    if _profiler_enabled() or _recording:
        if not _live:
            _start()
        return True
    if _live:
        _stop()
    return False


def _append(name, parent, rid, n, t0, t1) -> int:
    global _dropped
    if len(_records) >= LIMIT:
        _dropped += 1
        return -1
    _records.append([name, t0, t1, parent, rid, n])
    return len(_records) - 1


class _Span:
    __slots__ = ("name", "rid", "n", "i", "gen", "rf")

    def __init__(self, name, rid, n):
        self.name, self.rid, self.n = name, rid, n

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.gen = _generation
        self.i = _append(self.name, _stack[-1] if _stack else -1, self.rid,
                         self.n, _clock(), None)
        if self.i >= 0:
            _stack.append(self.i)
        return self

    def __exit__(self, *exc):
        if self.i >= 0 and self.gen == _generation:
            _records[self.i][2] = _clock()
            _stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, rid: Optional[int] = None, n: Optional[int] = None):
    """A context manager: a recorded span while on, else a shared null
    context."""
    return _Span(name, rid, n) if on() else _NULL


def mark(name: str, rid: Optional[int] = None) -> None:
    """A span of zero length under the innermost open span."""
    if on():
        t = _clock()
        _append(name, _stack[-1] if _stack else -1, rid, None, t, t)


def add(name: str, k) -> None:
    """Add ``k`` to the host counter ``name``."""
    if on():
        _counts[name] = _counts.get(name, 0) + k


def add_device(name: str, value: torch.Tensor) -> None:
    """Add the tensor ``value`` (a scalar) to the device counter ``name``:
    a running f64 sum on its device, read only by :func:`snapshot`."""
    if on():
        cur = _device.get(name)
        if cur is None:
            cur = _device[name] = torch.zeros((), dtype=torch.float64,
                                              device=value.device)
        cur.add_(value.detach())


def snapshot() -> Snapshot:
    """The spans so far (open ones with ``t1_ns`` None) and the counters,
    the device ones read once."""
    on()
    counters = dict(_counts)
    if _device:
        names = list(_device)
        values = torch.stack([_device[k] for k in names]).tolist()
        for k, v in zip(names, values):
            counters[k] = counters.get(k, 0) + v
    return Snapshot([Span(*r) for r in _records], counters, _dropped)


def clear() -> None:
    """Empty the buffer and the counters (spans open now record nothing
    more)."""
    global _dropped, _generation
    _records.clear()
    _stack.clear()
    _counts.clear()
    _device.clear()
    _dropped = 0
    _generation += 1


@contextlib.contextmanager
def recording():
    """Record inside this block, with no profiler running."""
    global _recording
    _recording += 1
    on()
    try:
        yield
    finally:
        _recording -= 1
        on()


# -- recording periods and hidden synchronisations ------------------------------

def _on_warning(message, category, filename, lineno, file=None, line=None):
    if str(message).startswith(SYNC_WARNING):
        where = _records[_stack[-1]][0] if _stack else "outside"
        key = f"{SYNC}.{where}"
        _counts[key] = _counts.get(key, 0) + 1
        t = _clock()
        _append(SYNC, _stack[-1] if _stack else -1, None, None, t, t)
        return
    prev = _saved.get("showwarning", warnings._showwarning_orig)
    if prev is warnings._showwarning_orig:
        # the default hook: through the module's own writer, which
        # ``catch_warnings(record=True)`` replaces
        warnings._showwarnmsg_impl(warnings.WarningMessage(
            message, category, filename, lineno, file, line))
    else:
        prev(message, category, filename, lineno, file, line)


def _start() -> None:
    global _live
    _live = True
    clear()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    _saved["filter"] = warnings.filters[0]
    _saved["showwarning"] = warnings.showwarning
    warnings.showwarning = _on_warning
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _saved["mode"] = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")


def _stop() -> None:
    global _live
    _live = False
    if "mode" in _saved:
        torch.cuda.set_sync_debug_mode(_saved.pop("mode"))
    if warnings.showwarning is _on_warning:
        warnings.showwarning = _saved["showwarning"]
    _saved.pop("showwarning", None)
    f = _saved.pop("filter", None)
    if f in warnings.filters:
        warnings.filters.remove(f)
        mutated = getattr(warnings, "_filters_mutated", None)
        if mutated is not None:
            mutated()
