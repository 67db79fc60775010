"""The request stream of a closed-loop serving mix, made from a seed.

A mix file gives the prompt and output lengths as log-normal
distributions (``median``, ``sigma``) clipped to ``[min, max]``.  The
lengths come in blocks of ``block`` requests: a block holds the lengths at
the quantiles ``(i + 0.5) / block`` of each distribution, and the seed only
shuffles them within the block (prompt and output lengths apart) and draws
the prompts' token ids.  So every seed offers the same set of sizes, in
another order, and runs with different seeds do the same work.

The first ``clients`` requests are the set-up's ramp: their outputs run
from 2 to about the median output length, evenly spread, so that the slots
free one after another and the loop reaches its steady state within about
one median request.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    rid: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int


def quantile_lengths(dist: Dict[str, Any], n: int) -> List[int]:
    """The lengths at the quantiles ``(i + 0.5) / n`` of the clipped
    log-normal ``dist``, in increasing order."""
    mu, sigma = math.log(dist["median"]), float(dist["sigma"])
    z = NormalDist()
    out = []
    for i in range(n):
        v = math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(v), dist["min"]), dist["max"])))
    return out


class Stream:
    """Requests ``0, 1, 2, ...`` of ``mix`` under ``seed`` for ``clients``
    clients and a vocabulary of ``vocab`` ids; ``take()`` returns the
    next one.  The same arguments give the same requests."""

    def __init__(self, mix: Dict[str, Any], seed: int, clients: int,
                 vocab: int):
        self.mix, self.seed, self.clients, self.vocab = \
            mix, int(seed), int(clients), int(vocab)
        self.block = int(mix["block"])
        self._prompt_q = quantile_lengths(mix["prompt"], self.block)
        self._output_q = quantile_lengths(mix["output"], self.block)
        self._blocks: Dict[int, tuple] = {}
        self.next_rid = 0

    def _lengths(self, i: int):
        b, j = divmod(i, self.block)
        if b not in self._blocks:
            rng = np.random.default_rng([self.seed, 1, b])
            self._blocks = {b: (rng.permutation(self._prompt_q),
                                rng.permutation(self._output_q))}
        prompts, outputs = self._blocks[b]
        return int(prompts[j]), int(outputs[j])

    def request(self, rid: int) -> RequestSpec:
        plen, out = self._lengths(rid)
        if rid < self.clients:
            out = 2 + (rid * (self.mix["output"]["median"] - 1)) \
                // self.clients
        rng = np.random.default_rng([self.seed, 2, rid])
        prompt = rng.integers(0, self.vocab, size=plen, dtype=np.int32)
        return RequestSpec(rid, prompt, int(out))

    def take(self) -> RequestSpec:
        spec = self.request(self.next_rid)
        self.next_rid += 1
        return spec
