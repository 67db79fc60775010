"""repro_torch.traces — serving-trace traffic: time-varying memory load
(port of :mod:`repro.traces`).

Per-tick traffic is recorded from live ``ServingEngine`` runs
(:class:`TraceRecorder`) or replayed synthetically from config shapes
alone (:func:`synthetic_serving_trace` — no weights), compiled into
:class:`TrafficTrace` phase sequences, and evaluated through the design
space's ``trace`` axis, where the simulators carry queue/credit state
across phase boundaries (on the card the ``symmetric_trace`` and
``asymmetric_trace`` kernels of ``csrc/flit_sim.cu``).
:func:`serving_frontier` is the headline report: the winning memory
approach per (model, QPS) point.
"""
from repro_torch.traces.arrival import (bursty_arrivals, diurnal_arrivals,
                                        diurnal_rate, poisson_arrivals,
                                        rate_from_users)
from repro_torch.traces.frontier import (DEFAULT_MODELS, DEFAULT_QPS,
                                         serving_frontier)
from repro_torch.traces.model_traffic import ModelTrafficSpec
from repro_torch.traces.recorder import TraceRecorder
from repro_torch.traces.synthetic import synthetic_serving_trace
from repro_torch.traces.trace import (MIN_BACKLOG, TrafficTrace, pad_traces)

__all__ = [
    "MIN_BACKLOG",
    "DEFAULT_MODELS",
    "DEFAULT_QPS",
    "ModelTrafficSpec",
    "TraceRecorder",
    "TrafficTrace",
    "bursty_arrivals",
    "diurnal_arrivals",
    "diurnal_rate",
    "pad_traces",
    "poisson_arrivals",
    "rate_from_users",
    "serving_frontier",
    "synthetic_serving_trace",
]
