"""Batched serving engine with continuous batching (port of
:mod:`repro.serve.engine`).

Fixed-slot decode batch: requests queue up, free slots are prefilled (one
request at a time, as on a real serving stack), and every engine tick
decodes one token for all active slots, greedily.  Completed sequences
(EOS or max tokens) free their slot.  (The reference's ``greedy`` and
``b`` attributes, which nothing reads, are not carried over.)

The engine serves every decoder-only family (a vision model without patch
embeddings, as the reference's engine passes ``{"tokens"}`` alone to
prefill) and refuses an encoder-decoder model, whose prefill needs frames
that a request does not carry.

Per-slot absolute positions let sequences of different lengths share one
decode batch (the decode path takes positions [B, 1]).  KV caches live
packed per slot in one ``[B, max_len, ...]`` buffer per layer; a prefill's
caches are copied into its slot in place.

Under a mesh (``ctx``, as the reference's engine takes one) every rank
runs the same admission and schedule on the same host state: the slots
split over the data axes (where they divide), every rank runs every
prefill and each splices it into its own block of the caches
(:meth:`Model.cache_specs`), and a decode step returns every slot's
logits on every rank, so each rank picks the same tokens.

An optional ``recorder`` observes every prefill, decode batch and tick
boundary through ``on_prefill(prompt_len)``, ``on_decode(positions)`` and
``on_tick(queued, active)``, at the same points as the reference's
``TraceRecorder`` hooks.  The hooks see token counts and context lengths
only, so recording adds no device work to the serving hot path.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding
from repro_torch.models.model import Model
from repro_torch.runtime import spans


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [T] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _splice(batch_c, one_c, slot: int) -> None:
    """Copy one request's caches (batch 1) into row ``slot`` of the batch
    buffers, in place (casting to the buffer's dtype)."""
    if isinstance(batch_c, dict):
        for key in batch_c:
            _splice(batch_c[key], one_c[key], slot)
    elif isinstance(batch_c, (tuple, list)):
        for b, o in zip(batch_c, one_c):
            _splice(b, o, slot)
    else:
        dst = batch_c[slot:slot + 1]
        if spans.on():
            spans.add("copy.splice", one_c.numel()
                      * (one_c.element_size() + dst.element_size()))
        dst.copy_(one_c)


def check_servable(cfg: ModelConfig, max_len: int) -> None:
    """Raise ``ValueError`` for a model the engine cannot serve:

    * an encoder-decoder model: its prefill needs frames for the encoder,
      which a request does not carry (the reference's engine passes tokens
      alone and fails at its first prefill);
    * a local-attention model whose ``max_len`` is below its window.  The
      reference allocates a ring of ``min(max_len, window)`` slots but
      gathers a prefilled prompt into ``window`` slots, so its first
      splice fails on a shape mismatch; the port refuses the setting up
      front."""
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name}: the engine serves token prompts, and an "
            f"encoder-decoder prefill needs frames for its encoder (the "
            f"reference's engine passes tokens alone and fails at the "
            f"first prefill); run it through Model.prefill(..., "
            f"frames=...) and Model.decode_step")
    if cfg.attention == "local" and max_len < cfg.window:
        raise ValueError(
            f"{cfg.name}: max_len={max_len} is below the local-attention "
            f"window={cfg.window}; the ring caches hold window positions, "
            f"so build the engine with max_len >= {cfg.window}")


class ServingEngine:
    def __init__(self, model: Model, params, batch_slots: int = 4,
                 max_len: int = 256, recorder: Any = None, device=None,
                 ctx=None):
        check_servable(model.cfg, max_len)
        self.model = model
        self.params = params
        self.ctx = ctx
        if sharding.active(ctx) and device is None:
            device = ctx.mesh.device
        self.device = device_mod.resolve(device)
        self.max_len = max_len
        self.recorder = recorder

        self.caches = model.init_decode_caches(batch_slots, max_len,
                                               self.device, ctx=ctx)
        # the slots whose cache rows this rank holds
        rows = sharding.batch_rows(ctx, batch_slots)[1]
        self.own = range(batch_slots)[rows]
        self.positions = np.zeros((batch_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.last_token = np.zeros((batch_slots,), np.int32)
        self.queue: deque = deque()
        self.finished: List[Request] = []

    # -- request lifecycle ------------------------------------------------
    def submit(self, req: Request):
        # a prompt at max_len - 1 leaves no room for even one decoded
        # token; past max_len the prefill would overflow the packed KV
        # slot and silently corrupt whatever sequence shares the buffer
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"does not fit the engine's max_len={self.max_len} KV "
                f"slots (need prompt length < max_len); truncate the "
                f"prompt or build the engine with a larger max_len")
        spans.mark("engine.submit", req.rid)
        self.queue.append(req)

    def _prefill_into_slot(self, slot: int, req: Request):
        with spans.span("engine.prefill", req.rid, len(req.prompt)):
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None, :]
            logits, caches = self.model.prefill(self.params, prompt,
                                                pad_cache_to=self.max_len,
                                                ctx=self.ctx)
            with spans.span("engine.read_first_token", req.rid):
                tok = int(torch.argmax(logits[0]))
        req.generated.append(tok)
        if slot in self.own:
            with spans.span("engine.splice", req.rid):
                _splice(self.caches, caches, slot - self.own.start)
        self.active[slot] = req
        self.positions[slot] = len(req.prompt)
        self.last_token[slot] = tok
        if self.recorder is not None:
            self.recorder.on_prefill(len(req.prompt))

    def _free_slot(self, slot: int):
        """Release a slot and reset its scalar state — stale positions /
        last_token must never leak into the next request admitted here."""
        self.active[slot] = None
        self.positions[slot] = 0
        self.last_token[slot] = 0

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    # -- engine tick --------------------------------------------------------
    def step(self) -> int:
        """Admit + decode one token for all active slots.  Returns the
        number of active sequences processed."""
        with spans.span("engine.step"):
            return self._step()

    def _step(self) -> int:
        for slot in self._free_slots():
            if not self.queue:
                break
            req = self.queue[0]
            with spans.span("engine.admit", req.rid):
                self.queue.popleft()
                self._prefill_into_slot(slot, req)

        active_idx = [i for i, r in enumerate(self.active) if r is not None]
        if not active_idx:
            if self.recorder is not None:
                self.recorder.on_tick(len(self.queue), 0)
            return 0
        if self.recorder is not None:
            self.recorder.on_decode([int(self.positions[i])
                                     for i in active_idx])

        with spans.span("engine.decode", n=len(active_idx)):
            self._decode(active_idx)
        if self.recorder is not None:
            self.recorder.on_tick(
                len(self.queue),
                sum(r is not None for r in self.active))
        return len(active_idx)

    def _decode(self, active_idx: List[int]) -> None:
        """One token for every active slot, read back and booked."""
        with spans.span("engine.decode_inputs"):
            tokens = torch.as_tensor(self.last_token.astype(np.int64),
                                     device=self.device)[:, None]
            positions = torch.as_tensor(self.positions.astype(np.int64),
                                        device=self.device)[:, None]
        logits, self.caches = self.model.decode_step(
            self.params, tokens, self.caches, positions, ctx=self.ctx)
        next_tokens = torch.argmax(logits, dim=-1)
        with spans.span("engine.read_tokens"):
            next_tokens = next_tokens.cpu().numpy()

        for i in active_idx:
            req = self.active[i]
            self.positions[i] += 1
            tok = int(next_tokens[i])
            req.generated.append(tok)
            self.last_token[i] = tok
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.generated) >= req.max_new_tokens
                    or self.positions[i] >= self.max_len - 1):
                req.done = True
                spans.mark("engine.finish", req.rid)
                self.finished.append(req)
                self._free_slot(i)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or any(r is not None for r in self.active)):
            self.step()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("engine did not drain")
        return self.finished
