"""Train step: microbatched gradient accumulation + AdamW + optional
gradient compression (port of :mod:`repro.train.train_step`).

  * params f32 masters, cast to bf16 where each layer uses them (eagerly,
    so again in each rematerialized layer's recompute; the reference's
    XLA hoists one cast a step)
  * gradients by autograd (``Model.loss``), accumulated in f32 over the
    microbatches, then averaged
  * per-layer remat inside the model where ``cfg.remat``
  * the step is functional: it returns a new state and leaves the old one
    as it was
  * under a mesh (``ctx``) every leaf of the state is the rank's block
    (:func:`state_specs`, :func:`shard_state`) and the batch its rows;
    each gradient arrives at its parameter's placement summed over the
    data axes (the FSDP gathers' backward reduce-scatters, the rest is
    all-reduced), microbatches split the rank's rows, and the clipping
    norm and the compression scales are global
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.models import sharding
from repro_torch.models.model import Model
from repro_torch.runtime import spans
from repro_torch.train import grad_compress
from repro_torch.train.optimizer import (AdamW, AdamWState, tree_leaves,
                                         tree_map)


#: the ``torch.profiler`` range around the optimizer update
OPTIMIZER_RANGE = "train_step.optimizer"


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    error_fb: Optional[Any]          # grad-compression error feedback


def init_state(model: Model, gen: torch.Generator, optimizer: AdamW,
               compress: bool = False) -> TrainState:
    """Parameters drawn from ``gen`` on ``gen``'s device, zero moments."""
    params = model.init(gen)
    return TrainState(params=params, opt=optimizer.init(params),
                      error_fb=(grad_compress.init_error_state(params)
                                if compress else None))


def state_specs(model: Model, ctx, compress: bool = False) -> TrainState:
    """The spec of every ``TrainState`` leaf (the reference's
    ``PartitionSpec`` entries): moments and error feedback as the
    parameters, the step replicated."""
    p = model.param_specs(ctx)
    return TrainState(params=p, opt=AdamWState(step=(), mu=p, nu=p),
                      error_fb=p if compress else None)


def shard_state(state: TrainState, model: Model, ctx) -> TrainState:
    """This rank's block of every leaf of a full state."""
    specs = state_specs(model, ctx, state.error_fb is not None)
    return TrainState(
        params=sharding.shard_tree(state.params, specs.params, ctx),
        opt=AdamWState(state.opt.step,
                       sharding.shard_tree(state.opt.mu, specs.params, ctx),
                       sharding.shard_tree(state.opt.nu, specs.params, ctx)),
        error_fb=sharding.shard_tree(state.error_fb, specs.params, ctx))


def unshard_state(state: TrainState, model: Model, ctx) -> TrainState:
    """Every leaf of a sharded state gathered whole (on every rank)."""
    specs = state_specs(model, ctx).params
    return TrainState(
        params=sharding.unshard_tree(state.params, specs, ctx),
        opt=AdamWState(state.opt.step,
                       sharding.unshard_tree(state.opt.mu, specs, ctx),
                       sharding.unshard_tree(state.opt.nu, specs, ctx)),
        error_fb=sharding.unshard_tree(state.error_fb, specs, ctx))


def value_and_grad(model: Model, params, batch: Dict[str, Any], ctx=None):
    """(loss, metrics, grads) of ``model.loss`` at ``params``: grads a tree
    like ``params`` (zeros for a leaf the loss does not reach, as JAX
    gives).  Under a mesh each gradient is the rank's block of the global
    one, summed over the data axes."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch, ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    grads = tree_map(lambda p: by_id[id(p)], live)
    if sharding.active(ctx):
        grads = sharding.reduce_grads(grads, model.param_specs(ctx), ctx)
    return loss.detach(), metrics, grads


def _split_microbatches(batch: Dict[str, Any], n_micro: int):
    """[B, ...] -> n_micro batches of [B / n_micro, ...] (under a mesh B is
    the rank's rows)."""
    def split(x):
        gb = x.shape[0]
        assert gb % n_micro == 0, (gb, n_micro)
        return x.reshape(n_micro, gb // n_micro, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def make_train_step(model: Model, optimizer: AdamW,
                    num_microbatches: int = 1, compress: bool = False,
                    ctx=None):
    """Returns train_step(state, batch) -> (state, metrics); under a mesh
    (``ctx``) on the rank's blocks and rows."""
    specs = model.param_specs(ctx) if sharding.active(ctx) else None

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state.params

        if num_microbatches == 1:
            loss, _, grads = value_and_grad(model, params, batch, ctx)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0].device)
            for mb in _split_microbatches(batch, num_microbatches):
                loss, _, g = value_and_grad(model, params, mb, ctx)
                grads = tree_map(lambda a, gi: a + gi.float(), grads, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / num_microbatches, grads)
            loss = loss_sum / num_microbatches

        error_fb = state.error_fb
        if compress and error_fb is not None:
            grads, error_fb = grad_compress.compress_tree(grads, error_fb,
                                                          ctx, specs)

        # a span (a profiler range): the step's kernel time splits into
        # the optimizer's and the rest
        with spans.span(OPTIMIZER_RANGE):
            new_params, opt_state, opt_metrics = optimizer.update(
                grads, state.opt, params, ctx, specs)
        out_metrics = {"loss": loss, **opt_metrics}
        return TrainState(new_params, opt_state, error_fb), out_metrics

    return train_step
