"""Phase-resolved traffic recording from live ``ServingEngine`` runs — port
of :mod:`repro.traces.recorder`.

A :class:`TraceRecorder` is handed to ``ServingEngine(recorder=...)``;
the engine reports every prefill, every decode batch, and every tick
boundary, and the recorder prices the events through the model's
:class:`~repro_torch.traces.model_traffic.ModelTrafficSpec` into per-tick
read/write bytes and outstanding-request backlog.  ``trace()`` compiles
the record into a :class:`TrafficTrace` for the ``trace`` axis.

The recorder observes token counts and context lengths only — it never
touches parameters or caches, so recording adds no device work to the
serving hot path.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.traces.model_traffic import ModelTrafficSpec
from repro_torch.traces.trace import TrafficTrace


class TraceRecorder:
    """Accumulates one serving run's per-tick memory-traffic record."""

    def __init__(self, spec: ModelTrafficSpec):
        self.spec = spec
        self._read: List[float] = []
        self._write: List[float] = []
        self._backlog: List[float] = []
        self._tick_read = 0.0
        self._tick_write = 0.0
        self._prefill_tokens = 0
        self._decode_tokens = 0
        self.prefill_tokens_per_tick: List[int] = []
        self.decode_tokens_per_tick: List[int] = []

    @classmethod
    def for_model(cls, cfg) -> "TraceRecorder":
        """Recorder priced for a :class:`repro_torch.configs.ModelConfig`."""
        return cls(ModelTrafficSpec.from_config(cfg))

    # -- engine callbacks -------------------------------------------------

    def on_prefill(self, prompt_len: int) -> None:
        """One request's prompt was prefilled into a slot this tick."""
        r, w = self.spec.prefill_bytes(prompt_len)
        self._tick_read += r
        self._tick_write += w
        self._prefill_tokens += int(prompt_len)

    def on_decode(self, context_lens: Sequence[int]) -> None:
        """One decode step ran for the given per-slot context lengths."""
        for ctx in context_lens:
            r, w = self.spec.decode_bytes(int(ctx))
            self._tick_read += r
            self._tick_write += w
        if len(context_lens):
            self._tick_read += self.spec.weight_stream_bytes
        self._decode_tokens += len(context_lens)

    def on_tick(self, queue_depth: int, active: int) -> None:
        """Close the tick: record its bytes and outstanding requests."""
        self._read.append(self._tick_read)
        self._write.append(self._tick_write)
        self._backlog.append(float(queue_depth + active))
        self.prefill_tokens_per_tick.append(self._prefill_tokens)
        self.decode_tokens_per_tick.append(self._decode_tokens)
        self._tick_read = self._tick_write = 0.0
        self._prefill_tokens = self._decode_tokens = 0

    # -- compilation ------------------------------------------------------

    @property
    def n_ticks(self) -> int:
        return len(self._read)

    def trace(self, n_phases: int = 8,
              name: Optional[str] = None) -> TrafficTrace:
        """Compile the recorded ticks into a phase trace."""
        if not self._read:
            raise ValueError("no ticks recorded; run the engine with "
                             "this recorder first")
        return TrafficTrace.from_ticks(
            name if name is not None else f"{self.spec.name}-recorded",
            self._read, self._write, self._backlog, n_phases=n_phases)
