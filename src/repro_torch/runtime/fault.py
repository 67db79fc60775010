"""Fault-tolerant training loop: checkpoint/restart, failure injection,
heartbeats (port of :mod:`repro.runtime.fault`).

``run`` owns the outer loop:
  * periodic async checkpoints (every ``ckpt_every`` steps)
  * a heartbeat file touched every step (external watchdogs restart the
    job when it goes stale)
  * simulated failures (``fail_at_steps``) raise mid-step; ``run``
    restores the latest committed checkpoint and replays — the
    deterministic step-indexed data pipeline makes the replay exact
  * bounded restarts (``max_restarts``)

A failure before the first checkpoint restarts from the state ``run`` was
given: the train step is functional, so that state is still the initial
one.  The reference keeps the state trained so far there and replays
steps 0.. on it (ROADMAP.md queue 3, R9).

Under a mesh (``ctx`` and the state's ``specs``) every rank runs the loop:
each saves and restores its own blocks (``ckpt``), a failure injected at
a step fails every rank there, and all restart from the last committed
step; each rank touches its own heartbeat file (``<path>.rank<r>``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.checkpoint import ckpt
from repro_torch.models import sharding


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    heartbeat_path: Optional[str] = None
    fail_at_steps: Sequence[int] = ()
    max_restarts: int = 3
    async_ckpt: bool = True


@dataclasses.dataclass
class RunReport:
    steps_run: int = 0
    restarts: int = 0
    restored_steps: List[int] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)


def run(train_step: Callable, state, batch_for_step: Callable,
        cfg: DriverConfig,
        on_step: Optional[Callable[[int, Dict], None]] = None,
        ctx=None, specs=None) -> RunReport:
    """Drive training with checkpoint/restart.

    train_step(state, batch) -> (state, metrics), leaving its input state
    as it was; batch_for_step(step) -> placed batch.  Restored leaves go
    to the devices of ``state``'s.  Under a mesh ``state`` is the rank's
    blocks and ``specs`` their specs.
    """
    placed = dict(ctx=ctx, specs=specs) if sharding.active(ctx) else {}
    heartbeat = cfg.heartbeat_path
    if heartbeat and placed:
        heartbeat = f"{heartbeat}.rank{ctx.mesh.rank}"
    report = RunReport()
    fail_pending = set(cfg.fail_at_steps)
    step = 0
    restarts = 0
    initial = state

    # resume if a checkpoint exists
    last = ckpt.latest_step(cfg.ckpt_dir)
    if last is not None:
        state, _ = ckpt.restore(cfg.ckpt_dir, target=state, **placed)
        step = last + 1
        report.restored_steps.append(last)

    while step < cfg.total_steps:
        try:
            if step in fail_pending:
                fail_pending.discard(step)
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = batch_for_step(step)
            state, metrics = train_step(state, batch)
            if heartbeat:
                with open(heartbeat, "w") as f:
                    f.write(f"{step} {time.time()}\n")
            if on_step is not None:
                on_step(step, metrics)
            if "loss" in metrics:
                report.losses.append(float(metrics["loss"]))
            if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
                ckpt.save(state, step, cfg.ckpt_dir,
                          asynchronous=cfg.async_ckpt, **placed)
            report.steps_run += 1
            step += 1
        except SimulatedFailure:
            restarts += 1
            report.restarts = restarts
            if restarts > cfg.max_restarts:
                raise
            ckpt.wait()
            last = ckpt.latest_step(cfg.ckpt_dir)
            if last is None:
                state, step = initial, 0     # restart from scratch
                continue
            state, _ = ckpt.restore(cfg.ckpt_dir, target=state, **placed)
            report.restored_steps.append(last)
            step = last + 1
    ckpt.wait()
    return report
