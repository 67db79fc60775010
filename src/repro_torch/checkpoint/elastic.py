"""Elastic scaling: restore any checkpoint onto any mesh (port of
:mod:`repro.checkpoint.elastic`).

The checkpoint format is mesh-agnostic (shards carry global indices), so
elasticity is: build the new mesh, derive each leaf's spec from the
model's logical-axis schema, and read each rank's block.  A checkpoint in
the reference's layout (its homogeneous layers stacked along ``[L, ...]``)
goes through :func:`repro_torch.convert.train_state` first.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import Model
from repro_torch.models.sharding import ShardingCtx, active


def mesh_for_devices(n_devices: int, model_axis: int = 1):
    """The (data, model) mesh of ``n_devices`` ranks (model fixed): live
    over the initialized world, whose size it must be."""
    if n_devices % model_axis:
        raise ValueError(f"{n_devices} ranks do not split into 'model' "
                         f"groups of {model_axis}")
    return mesh_mod.init_mesh((n_devices // model_axis, model_axis),
                              ("data", "model"))


def _target(model: Model, ctx: ShardingCtx, compress: bool):
    """A ``TrainState`` of empty (meta) leaves of the rank's block shapes,
    and its specs."""
    from repro_torch.models.sharding import local_shape
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState, state_specs
    specs = state_specs(model, ctx, compress)

    def empty(schema, spec):
        if isinstance(schema, dict):
            return {k: empty(schema[k], spec[k]) for k in schema}
        return torch.empty(local_shape(schema.shape, spec, ctx),
                           dtype=schema.dtype, device="meta")
    params = empty(model.schema, specs.params)
    return TrainState(
        params=params,
        opt=AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                       params, params),
        error_fb=params if compress else None), specs


def restore_elastic(directory: str, model: Model, ctx: Optional[ShardingCtx],
                    step: Optional[int] = None, device=None,
                    compress: bool = False):
    """Restore a ``TrainState`` saved under ANY mesh (the port's or the
    reference's, sharded or not) onto ``ctx``'s mesh (``None``: one
    device); returns (state, step)."""
    from repro_torch import convert
    from repro_torch.train.train_step import shard_state
    dev = torch.device(device) if device is not None else (
        ctx.mesh.device if active(ctx) else torch.device("cpu"))
    stepdir, step = ckpt._stepdir(directory, step)
    with open(os.path.join(stepdir, ckpt._MANIFEST)) as f:
        names = set(json.load(f)["leaves"])
    target, specs = _target(model, ctx if active(ctx) else ShardingCtx(),
                            compress)
    if {n for n, _ in ckpt._leaf_paths(target)} <= names:
        return ckpt.restore(directory, target, step, ctx=ctx,
                            specs=specs if active(ctx) else None,
                            device=dev)
    tree, step = ckpt.load(directory, step)
    state = convert.train_state(model.cfg, tree, device=dev)
    return (shard_state(state, model, ctx) if active(ctx) else state), step
