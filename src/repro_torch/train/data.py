"""Deterministic, step-indexed synthetic data pipeline (port of
:mod:`repro.train.data`).

Fault-tolerance contract: ``batch_for_step(step)`` is a pure function of
(seed, step), so a restart from checkpoint step N reproduces the exact
byte-identical stream from step N+1 — no data-loader state to persist.
The numpy draws are the reference's, in its order, so both packages
train on the same bytes.

The token stream is a mixture of (a) a Zipf-like unigram draw and (b)
short deterministic motifs (so the model has learnable structure and the
loss visibly falls).  Host-side numpy generation; :meth:`SyntheticLM.place`
puts a batch on one explicit device (f32 arrays as bf16, as the
reference's single-device ``place``; integers as int64, PyTorch's index
type), or under a mesh this rank's rows of it (f32 arrays as f32, as the
reference places them on a mesh); :class:`Prefetcher` double-buffers it
on a background thread.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec

from repro_torch.models import sharding


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_alpha: float = 1.2
    motif_period: int = 17


class SyntheticLM:
    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 data_cfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        v = cfg.vocab_size
        # Zipf-ish unigram distribution over a clipped vocab
        ranks = np.arange(1, min(v, 4096) + 1, dtype=np.float64)
        probs = 1.0 / ranks ** data_cfg.zipf_alpha
        self._probs = probs / probs.sum()
        self._vocab = len(self._probs)

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.data_cfg.seed, step]))
        b, s = self.shape.global_batch, self.shape.seq_len
        cfg = self.cfg
        tokens = rng.choice(self._vocab, size=(b, s), p=self._probs)
        # deterministic motif: position-dependent token every `period`
        period = self.data_cfg.motif_period
        pos = np.arange(s)
        motif_mask = (pos % period) == 0
        tokens[:, motif_mask] = (pos[motif_mask] // period) % 97 + 2
        tokens = tokens.astype(np.int32)

        if cfg.is_encdec:
            frames = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32) * 0.02
            return {"frames": frames, "tokens": tokens, "labels": tokens}
        if cfg.frontend == "vision":
            p = cfg.frontend_tokens
            tokens = tokens[:, : s - p]
            pe = rng.standard_normal(
                (b, p, cfg.d_model)).astype(np.float32) * 0.02
            return {"tokens": tokens, "patch_embeds": pe, "labels": tokens}
        return {"tokens": tokens, "labels": tokens}

    def place(self, batch: Dict[str, np.ndarray], device,
              ctx=None) -> Dict[str, torch.Tensor]:
        """The batch as tensors on ``device``: f32 arrays as bf16,
        integer arrays as int64.  Under a mesh (``ctx``) this rank's rows
        (the batch split over the data axes, which must divide it) and
        f32 arrays as f32."""
        out = {}
        for k, v in batch.items():
            if sharding.active(ctx):
                n = ctx.dp_size()
                if v.shape[0] % n:
                    raise ValueError(f"batch of {v.shape[0]} rows does not "
                                     f"split over {n} data ranks")
                i = ctx.index_of(ctx.dp_axes)
                v = v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
            if v.dtype == np.float32:
                t = torch.from_numpy(np.ascontiguousarray(v))
                if not sharding.active(ctx):
                    t = t.to(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(v, np.int64))
            out[k] = t.to(device)
        return out


class Prefetcher:
    """Double-buffered background prefetch of batch_for_step, placed on
    ``device``."""

    def __init__(self, source: SyntheticLM, device, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.device = device
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_for_step(step)
            placed = self.source.place(batch, self.device)
            while not self._stop.is_set():
                try:
                    self.q.put((step, placed), timeout=1.0)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
