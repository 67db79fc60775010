"""The expert choices of MoE layers, recorded while a model runs, and the
check that two runs part in them only because their router inputs differ.

Two runs of one model (on the card and on the CPU; the port and the JAX
reference; a prefill and decode steps) round the bf16 residual stream at
other places, so the router's input differs by a few roundings and a
token whose k-th and (k+1)-th probabilities nearly tie may take another
expert in each.  :func:`parted` shows that cause at every token whose
choices differ: side A's router, run on side B's input, must pick B's
experts.  Where even that parts (the two routers' f32 products are summed
in other orders), the experts A's router picks on B's input and B's own
must be, choice by choice, within ``TIE_ULPS`` f32 ulps of the token's
k-th probability of each other.  Anything else is a divergence of the
router, and fails.

A check, not part of the forward: the tests and ``chip_smoke.py`` use it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe

#: f32 ulps of the k-th probability within which two routers, on one
#: input, may order two experts either way
TIE_ULPS = 8

#: the router itself, whatever recorder is active
_route = moe.route


class Routes:
    """Inside a ``with`` block, every MoE layer call's router input
    ``xt``, router weights ``w``, probabilities ``probs`` and chosen
    experts ``own``, in call order, recorded by a wrapper of
    ``moe.route``.  With ``forced`` (the experts of each call) the model
    takes those instead, its own still recorded."""

    def __init__(self, forced=None):
        self.forced = forced
        self.xt, self.w, self.probs, self.own = [], [], [], []

    def __enter__(self):
        moe.route = self._wrap
        return self

    def __exit__(self, *exc):
        moe.route = _route

    def _wrap(self, xt, w, cfg):
        probs, top_w, top_e = _route(xt, w, cfg)
        self.xt.append(xt)
        self.w.append(w)
        self.probs.append(probs)
        self.own.append(top_e)
        if self.forced is None:
            return probs, top_w, top_e
        e = self.forced[len(self.own) - 1].to(probs.device)
        return probs, moe.gate_weights(probs, e), e

    def per_layer(self, layers: int) -> "Routes":
        """The calls of each layer (a prefill, then decode steps) joined
        along the tokens: one call a layer."""
        out = Routes()
        for i in range(layers):
            out.xt.append(torch.cat(self.xt[i::layers]))
            out.w.append(self.w[i])
            out.probs.append(torch.cat(self.probs[i::layers]))
            out.own.append(torch.cat(self.own[i::layers]))
        return out


def ulp(p: torch.Tensor) -> torch.Tensor:
    """The f32 spacing at each (positive) value of ``p``."""
    return torch.ldexp(torch.ones_like(p), torch.frexp(p).exponent - 24)


@torch.no_grad()
def parted(a: Routes, b: Routes, cfg: ModelConfig, what: str) -> list:
    """Compare ``a``'s calls with ``b``'s, one by one (the same layers on
    the same tokens; ``b`` needs ``xt``, ``probs`` and ``own``).  Per
    call: the smallest gap between ``a``'s k-th and (k+1)-th probability
    (``min_gap``); the tokens whose expert set differs (``sets``) or only
    its order (``order``); how many of them ``a``'s router, on ``b``'s
    input, gives ``b``'s experts (``by_input``); how far apart, in f32
    ulps of the k-th probability, the experts of the others are on that
    input (``ulps``); and the largest difference between ``a``'s router
    and ``b``'s on ``b``'s input, in f32 ulps of each probability
    (``router_ulps``).  Raises where ``ulps`` passes ``TIE_ULPS``."""
    assert len(a.own) == len(b.own), (what, len(a.own), len(b.own))
    k, out = cfg.experts_per_token, []
    for i, (probs, own) in enumerate(zip(a.probs, a.own)):
        dev = probs.device
        xt_b, p_b, own_b = (t.to(dev) for t in (b.xt[i], b.probs[i],
                                                 b.own[i]))
        top = torch.sort(probs, dim=-1, descending=True)[0]
        differ = (own != own_b).any(1)
        sets = (torch.sort(own, 1)[0] != torch.sort(own_b, 1)[0]).any(1)
        px, _, ex = _route(xt_b, a.w[i], cfg)
        kth = torch.sort(px, dim=-1, descending=True)[0][:, k - 1]
        dist = (px.gather(1, ex) - px.gather(1, own_b)).abs().amax(1) \
            / ulp(kth)
        same = differ & (ex == own_b).all(1)
        rest = differ & ~same
        rep = dict(min_gap=float((top[:, k - 1] - top[:, k]).min()),
                   sets=int(sets.sum()), order=int((differ & ~sets).sum()),
                   by_input=int(same.sum()),
                   ulps=float(dist[rest].max()) if bool(rest.any()) else 0.0,
                   router_ulps=float(((px - p_b).abs() / ulp(p_b)).max()))
        if rep["ulps"] > TIE_ULPS:
            raise AssertionError(
                f"{what}: call {i}: tokens "
                f"{torch.nonzero(rest).flatten().tolist()} take other "
                f"experts than the other side, on its own router input "
                f"too, {rep['ulps']:.1f} f32 ulps of the k-th probability "
                f"apart (more than {TIE_ULPS}): {rep}")
        out.append(rep)
    return out
