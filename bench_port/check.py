"""Whether what the timed path served is correct.

Once the window has closed, a sample of the requests that finished in it
(drawn from the seed, the one with the most served tokens always in it)
is run through the configuration's plain reference, teacher-forced on each
prompt and its served tokens.  At each served token the gap by which the
token's logit lies below the reference's best logit is read; the widest
gap over the sample is compared with the cell's limit.  A served count
short of the request's ``max_new_tokens`` is compared exactly.

:func:`gaps` also gives the control's reading: the same reference in a
lower precision (``fp8``) in the port's place, its top token at each of
the same positions, judged by the f32 reference.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from bench_port.reference.plain import exact_f32


def sample(finished: Sequence, n: int, seed: int) -> List:
    """``n`` of ``finished`` (tracks), drawn from ``seed``: the one with
    the most served tokens (then the longest prompt, then the first), and
    ``n - 1`` more at random."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: (
        -len(finished[i].req.generated), -len(finished[i].spec.prompt), i))
    first, rest = order[0], order[1:]
    rng = np.random.default_rng([int(seed), 3])
    more = rng.permutation(len(rest))[:max(n - 1, 0)]
    return [finished[first]] + [finished[rest[i]] for i in sorted(more)]


def reference_of(config) :
    return importlib.import_module(
        f"bench_port.reference.{config['reference']}")


def gaps(config, weights, tracks, device,
         precisions: Sequence[str] = ()) -> Dict[str, np.ndarray]:
    """Per served token of ``tracks``: ``"served"``, the gap of the served
    token under the f32 reference, ``"request"``, the index of its track,
    and for each of ``precisions`` the gap of the token the reference in
    that precision puts first."""
    ref = reference_of(config)
    m = config["model"]
    out: Dict[str, list] = {"served": [], "request": []}
    out.update({p: [] for p in precisions})
    with torch.no_grad(), exact_f32():
        for i, tr in enumerate(tracks):
            prompt = torch.as_tensor(np.asarray(tr.spec.prompt, np.int64),
                                     device=device)
            served = torch.as_tensor(tr.req.generated, dtype=torch.long,
                                     device=device)
            lg = ref.served_logits(weights, m, prompt, served, "f32")
            best = lg.max(dim=-1).values
            pick = lambda toks: (best - lg.gather(1, toks[:, None])[:, 0])
            out["served"].append(pick(served).cpu())
            out["request"].append(torch.full((len(served),), i))
            for p in precisions:
                low = ref.served_logits(weights, m, prompt, served, p)
                out[p].append(pick(low.argmax(dim=-1)).cpu())
                del low
            del lg
    return {k: torch.cat(v).numpy() if v else np.zeros(0)
            for k, v in out.items()}


def judge(cell, tracks, g: Dict[str, np.ndarray]):
    """``tracks`` and their :func:`gaps` ``g`` -> (the numbers compared,
    each with its limit; the number of sampled requests that fail one).
    ``logit_gap``: the widest gap of a served token; ``tokens_short``:
    served tokens missing from the sample's requests (exact);
    ``requests_checked``: at least one."""
    limit = float(cell.workload["check"]["limits"]["logit_gap"])
    short = [tr.spec.max_new_tokens - len(tr.req.generated)
             for tr in tracks]
    bad = {int(i) for i in g["request"][g["served"] > limit]}
    bad |= {i for i, n in enumerate(short) if n != 0}
    checks = {
        "logit_gap": {"value": float(g["served"].max())
                      if g["served"].size else float("nan"),
                      "limit": limit},
        "tokens_short": {"value": float(sum(short)), "limit": 0.0},
        "requests_checked": {"value": float(len(tracks)), "limit": 1.0},
    }
    return checks, len(bad)


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number within its limit (``requests_checked`` at least its
    limit, the others at most theirs)."""
    ok = checks["requests_checked"]["value"] >= \
        checks["requests_checked"]["limit"]
    for name, c in checks.items():
        if name != "requests_checked":
            ok = ok and c["value"] <= c["limit"]
    return bool(ok)
