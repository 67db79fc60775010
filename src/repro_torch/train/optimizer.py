"""AdamW with f32 master weights, global-norm clipping, and LR schedules
(port of :mod:`repro.train.optimizer`).

Parameters, gradients and moments are nested dicts of tensors with one
structure (:func:`tree_map`).  The update is functional, as the
reference's: it returns new tensors and leaves its inputs untouched, so
a caller may keep an earlier state (the fault-tolerant loop keeps the
initial one).  Every operation is the reference's, in its order, on f32.
Under a mesh the leaves are each rank's blocks and the update is
elementwise on them; only the clipping norm is global
(:func:`global_norm` with the leaves' specs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import sharding


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts, keys in sorted order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    mu: Any                      # first moment, like params
    nu: Any                      # second moment, like params


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        dev = tree_leaves(params)[0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params),
            nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params))

    def update(self, grads, state: AdamWState, params, ctx=None,
               specs=None) -> Tuple[Any, AdamWState, dict]:
        """One step; under a mesh ``ctx`` and the parameters' ``specs``
        make the clipping norm the global one."""
        grads = tree_map(lambda g: g.float(), grads)
        gnorm = global_norm(grads, ctx, specs)
        if self.grad_clip_norm is not None:
            scale = torch.clamp(self.grad_clip_norm
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        lr = self.learning_rate(step)
        b1c = 1.0 - self.b1 ** step.float()
        b2c = 1.0 - self.b2 ** step.float()

        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                      state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                      state.nu, grads)

        def upd(p, m, v):
            mh = m / b1c
            vh = v / b2c
            u = mh / (torch.sqrt(vh) + self.eps)
            u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step, mu, nu), {
            "grad_norm": gnorm, "lr": lr}


def global_norm(tree, ctx=None, specs=None) -> torch.Tensor:
    """The 2-norm of every leaf together.  Under a mesh (each leaf a
    rank's block, ``specs`` its spec) each leaf's sum of squares is summed
    over the axes it is sharded on, once per set of axes, and not over
    those it is replicated on."""
    if not sharding.active(ctx):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree_leaves(tree)))
    by_axes = {}
    for g, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        axes = tuple(a for a in ctx.mesh.axis_names
                     if a in sharding.sharded_axes(spec))
        by_axes[axes] = by_axes.get(axes, 0.0) + torch.sum(
            torch.square(g.float()))
    total = sum(sharding.all_reduce(v, ctx, axes) if axes else v
                for axes, v in sorted(by_axes.items()))
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    def lr(step):
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return lr


def constant_schedule(lr_value: float):
    return lambda step: torch.full((), lr_value, dtype=torch.float32,
                                   device=step.device)
