"""Request arrival processes — port of :mod:`repro.traces.arrival`.

Numpy only, with the reference's seeded generator calls, so the
arrivals are equal value for value.  All generators return an integer array of request arrivals per engine
tick, deterministic in ``seed`` (numpy ``default_rng``).  Rates are in
requests per tick; aggregate user populations fold into the rate —
superposing millions of independent per-user request streams is again
Poisson (:func:`rate_from_users`), so "N concurrent users" is one rate
scalar, not N simulated actors.

Three processes cover the regimes the serving frontier sweeps:

* :func:`poisson_arrivals` — stationary load (the M/./. baseline).
* :func:`diurnal_arrivals` — a sinusoidal day/night rate swing
  (``peak_ratio`` peak:trough) modulating the Poisson draw, so one trace
  carries both the loaded and the drained regime.
* :func:`bursty_arrivals` — a two-state (quiet/burst) Markov-modulated
  Poisson process: flash-crowd spikes of ``burst_factor`` x the base
  rate with geometric burst lengths.
"""
from __future__ import annotations

import numpy as np


def rate_from_users(users: float, requests_per_user_per_tick: float
                    ) -> float:
    """Aggregate request rate of ``users`` independent users — the
    superposition of per-user Poisson streams is Poisson at the summed
    rate, which is how traces model millions of concurrent users."""
    if users < 0 or requests_per_user_per_tick < 0:
        raise ValueError("users and per-user rate must be >= 0")
    return float(users) * float(requests_per_user_per_tick)


def poisson_arrivals(rate: float, n_ticks: int, seed: int = 0
                     ) -> np.ndarray:
    """Stationary Poisson arrivals: ``rate`` requests per tick."""
    if rate < 0:
        raise ValueError(f"rate must be >= 0, got {rate}")
    rng = np.random.default_rng(seed)
    return rng.poisson(rate, int(n_ticks)).astype(np.int64)


def diurnal_rate(base_rate: float, n_ticks: int, peak_ratio: float = 4.0,
                 period: int = 0) -> np.ndarray:
    """Sinusoidal rate profile with mean ``base_rate`` and peak:trough
    ratio ``peak_ratio`` (``period`` ticks per cycle; 0 -> one full cycle
    over the record)."""
    if peak_ratio < 1.0:
        raise ValueError(f"peak_ratio must be >= 1, got {peak_ratio}")
    period = int(period) if period else int(n_ticks)
    t = np.arange(int(n_ticks), dtype=np.float64)
    # mean 1, swing a: peak (1+a) / trough (1-a) == peak_ratio
    a = (peak_ratio - 1.0) / (peak_ratio + 1.0)
    return base_rate * (1.0 + a * np.sin(2.0 * np.pi * t / period))


def diurnal_arrivals(base_rate: float, n_ticks: int,
                     peak_ratio: float = 4.0, period: int = 0,
                     seed: int = 0) -> np.ndarray:
    """Poisson arrivals under the :func:`diurnal_rate` profile."""
    rng = np.random.default_rng(seed)
    return rng.poisson(diurnal_rate(base_rate, n_ticks, peak_ratio,
                                    period)).astype(np.int64)


def bursty_arrivals(base_rate: float, n_ticks: int,
                    burst_factor: float = 8.0, burst_prob: float = 0.05,
                    mean_burst_len: float = 16.0, seed: int = 0
                    ) -> np.ndarray:
    """Markov-modulated Poisson arrivals: a quiet state at ``base_rate``
    and a burst state at ``burst_factor * base_rate``, entered with
    per-tick probability ``burst_prob`` and left with probability
    ``1 / mean_burst_len``."""
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    if not 0.0 <= burst_prob <= 1.0:
        raise ValueError(f"burst_prob must be in [0, 1], got {burst_prob}")
    if mean_burst_len < 1.0:
        raise ValueError(f"mean_burst_len must be >= 1, got "
                         f"{mean_burst_len}")
    rng = np.random.default_rng(seed)
    n = int(n_ticks)
    rates = np.empty(n, np.float64)
    in_burst = False
    for t in range(n):
        if in_burst:
            if rng.random() < 1.0 / mean_burst_len:
                in_burst = False
        elif rng.random() < burst_prob:
            in_burst = True
        rates[t] = base_rate * (burst_factor if in_burst else 1.0)
    return rng.poisson(rates).astype(np.int64)
