"""The check fails a run whose timed path is broken underneath: the
harness drives a whole run on the CPU at the reduced sizes with the
port's decode step broken, and ``correct`` comes out false.  (One card:
no exchange between chips to leave out.)  A state left unchanged reads
least: a step misses the tokens decoded before it, a share of the context
that long prompts make small, so the reduced cells' requests have short
prompts and longer outputs (``conftest.SHORT_MIX``)."""
import pytest
import torch

from bench_port import session
from bench_port.conftest import reduced

SEED = 2 ** 31 + 23


def _unchanged_state(orig):
    """A decode step that returns its caches as they came in."""
    def step(self, params, tokens, caches, positions, ctx=None):
        kept = torch.utils._pytree.tree_map(torch.clone, caches)
        logits, _ = orig(self, params, tokens, caches, positions, ctx)
        return logits, kept
    return step


def _half_batch(orig):
    """A decode step that computes half of the slots and gives the other
    half the mean of their logits (the halves swap every tick, so that
    every request meets the fault)."""
    ticks = []

    def step(self, params, tokens, caches, positions, ctx=None):
        logits, caches = orig(self, params, tokens, caches, positions, ctx)
        ticks.append(1)
        half = logits.shape[0] // 2
        kept, lost = (slice(0, half), slice(half, None))[::(
            1 if len(ticks) % 2 else -1)]
        logits = logits.clone()
        logits[lost] = logits[kept].float().mean(0).to(logits.dtype)
        return logits, caches
    return step


def _altered_token(orig):
    """A decode step that, every third tick, moves each slot's top token
    by one id."""
    ticks = []

    def step(self, params, tokens, caches, positions, ctx=None):
        logits, caches = orig(self, params, tokens, caches, positions, ctx)
        ticks.append(1)
        if len(ticks) % 3 == 0:
            logits = torch.roll(logits, 1, dims=-1)
        return logits, caches
    return step


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_token": _altered_token}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["olmoe-1b-7b.code_long_prompt",
                                  "mamba2-2.7b.code_long_prompt",
                                  "olmoe-1b-7b.chat_decode"])
def test_broken_decode_is_not_correct(name, fault, monkeypatch):
    from repro_torch.models.model import Model
    monkeypatch.setattr(Model, "decode_step",
                        FAULTS[fault](Model.decode_step))
    cell = reduced(name)
    out = session.execute(cell, SEED, 2.0, False, device="cpu")
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1
    c = out["checks"]["logit_gap"]
    assert c["value"] > c["limit"]
