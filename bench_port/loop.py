"""The closed loop that drives ``ServingEngine`` and what it records.

``clients`` clients each hold one request at a time: a client submits its
next request (``ServingEngine.submit``) as soon as its previous one has
finished, and the loop calls ``ServingEngine.step`` again and again.  The
engine's recorder hooks (``on_prefill`` after the prefill's first token
reached the host, ``on_decode`` before a decode tick, ``on_tick`` after
the tick's tokens reached the host) are timed on the host clock by
:class:`Recorder`, the benchmark's own object, with the start and end of
every step.  From them every token of every request gets the host time it
came back.

The set-up's part of the loop (:meth:`ClosedLoop.ramp`) runs until every
slot has been refilled at least once; the window (:meth:`ClosedLoop.run`)
then runs whole steps until ``seconds`` have passed, so it opens and
closes on step boundaries, where the device is idle (every step ends by
reading its tokens on the host).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

clock = time.perf_counter


@dataclasses.dataclass
class Step:
    t_start: float
    t_end: float = 0.0
    prefills: List[Tuple[float, float, int]] = dataclasses.field(
        default_factory=list)           # (begin, end, prompt length)
    decode: Optional[Tuple[float, float, Tuple[int, ...]]] = None
    # (on_decode, on_tick, the active slots' positions)

    def phases(self) -> List[Tuple[float, float, str]]:
        """The host's phases in this step: ``prefill`` (from the step's
        start or the previous prefill's end to each first token),
        ``admission`` (from there to the decode) and ``decode`` (the tick,
        its tokens read back)."""
        out, cursor = [], self.t_start
        for _, end, _ in self.prefills:
            out.append((cursor, end, "prefill"))
            cursor = end
        if self.decode is not None:
            out.append((cursor, self.decode[0], "admission"))
            out.append((self.decode[0], self.t_end, "decode"))
        else:
            out.append((cursor, self.t_end, "admission"))
        return out


class Recorder:
    """The engine's recorder: host times of every hook, step by step."""

    def __init__(self):
        self.steps: List[Step] = []
        self._cursor = 0.0
        self._decode_at = 0.0
        self._positions: Tuple[int, ...] = ()

    def begin_step(self) -> None:
        t = clock()
        self.steps.append(Step(t))
        self._cursor = t

    def end_step(self) -> None:
        self.steps[-1].t_end = clock()

    def on_prefill(self, prompt_len: int) -> None:
        t = clock()
        self.steps[-1].prefills.append((self._cursor, t, int(prompt_len)))
        self._cursor = t

    def on_decode(self, positions) -> None:
        self._decode_at = clock()
        self._positions = tuple(int(p) for p in positions)

    def on_tick(self, queued: int, active: int) -> None:
        if self._positions:
            self.steps[-1].decode = (self._decode_at, clock(),
                                     self._positions)
        self._positions = ()


@dataclasses.dataclass
class Track:
    """One request as the client sees it."""
    spec: object                      # traffic.generator.RequestSpec
    req: object                       # serve.engine.Request
    t_submit: float
    times: List[float] = dataclasses.field(default_factory=list)
    t_done: Optional[float] = None


class ClosedLoop:
    def __init__(self, engine, stream, clients: int):
        from repro_torch.serve.engine import Request
        self._request = Request
        self.engine = engine
        self.stream = stream
        self.rec: Recorder = engine.recorder
        self.tracks: List[Track] = []
        self._pending: Deque[Track] = deque()   # submitted, not prefilled
        self._running: List[Track] = []
        for _ in range(clients):
            self._submit()

    def _submit(self) -> None:
        spec = self.stream.take()
        req = self._request(rid=spec.rid, prompt=spec.prompt,
                            max_new_tokens=spec.max_new_tokens)
        tr = Track(spec, req, clock())
        self.engine.submit(req)
        self.tracks.append(tr)
        self._pending.append(tr)

    def step(self) -> Step:
        """One engine step; the tokens it returned get their host times,
        and each client whose request finished submits its next one."""
        self.rec.begin_step()
        self.engine.step()
        self.rec.end_step()
        st = self.rec.steps[-1]
        for _, end, plen in st.prefills:
            tr = self._pending.popleft()
            if len(tr.spec.prompt) != plen:
                raise RuntimeError(f"request {tr.spec.rid}: prefilled "
                                   f"{plen} tokens, its prompt has "
                                   f"{len(tr.spec.prompt)}")
            tr.times.append(end)
            self._running.append(tr)
        still = []
        for tr in self._running:
            new = len(tr.req.generated) - len(tr.times)
            if new == 1 and st.decode is not None:
                tr.times.append(st.decode[1])
            elif new != 0:
                raise RuntimeError(f"request {tr.spec.rid}: {new} tokens "
                                   f"in one step")
            if tr.req.done:
                tr.t_done = tr.times[-1]
            else:
                still.append(tr)
        finished = len(self._running) - len(still)
        self._running = still
        for _ in range(finished):
            self._submit()
        return st

    def ramp(self) -> None:
        """Steps until every slot has been refilled at least once."""
        first = [None] * len(self.engine.active)
        refilled = [False] * len(first)
        while not all(refilled):
            self.step()
            for i, r in enumerate(self.engine.active):
                if r is None:
                    continue
                if first[i] is None:
                    first[i] = r.rid
                elif r.rid != first[i]:
                    refilled[i] = True

    def run(self, seconds: float,
            on_step: Optional[Callable[[float], None]] = None
            ) -> Tuple[float, float]:
        """Whole steps until ``seconds`` have passed -> (open, close) on
        the host clock.  ``on_step(elapsed)`` runs at every step boundary
        inside the window, before the next step."""
        t_open = clock()
        while True:
            st = self.step()
            elapsed = st.t_end - t_open
            if elapsed >= seconds:
                return t_open, st.t_end
            if on_step is not None:
                on_step(elapsed)


@dataclasses.dataclass
class Window:
    """What a metric reader sees of the window."""
    t_open: float
    t_close: float
    steps: List[Step]                 # the window's whole steps
    tracks: List[Track]               # every request of the run

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def inside(self, t: float) -> bool:
        return self.t_open <= t <= self.t_close

    def token_times(self) -> np.ndarray:
        return np.array([t for tr in self.tracks for t in tr.times
                         if self.inside(t)])

    def ttft_s(self) -> np.ndarray:
        return np.array([tr.times[0] - tr.t_submit for tr in self.tracks
                         if tr.times and self.inside(tr.times[0])])

    def gaps_s(self) -> np.ndarray:
        return np.array([b - a for tr in self.tracks
                         for a, b in zip(tr.times, tr.times[1:])
                         if self.inside(b)])

    def finished(self) -> List[Track]:
        return [tr for tr in self.tracks
                if tr.t_done is not None and self.inside(tr.t_done)]


def window_of(loop: ClosedLoop, t_open: float, t_close: float) -> Window:
    steps = [s for s in loop.rec.steps
             if s.t_start >= t_open and s.t_end <= t_close]
    return Window(t_open, t_close, steps, loop.tracks)
