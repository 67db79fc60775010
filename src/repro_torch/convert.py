"""Carry the JAX reference's state across to the port.

The reference keeps its flit-simulator state as parameter stacks
(``SymmetricFlitParams`` / ``AsymmetricLaneParams`` whose fields are
``[P]`` arrays) and row-stacked ``[rows, cells]`` kernel operands and
states, its flit-packing data path as int32 byte arrays, and its LM
parameters and decode caches as nested dicts whose homogeneous layers are
stacked along a leading ``[L, ...]`` axis.  These helpers turn numpy
copies of any of them (``np.asarray`` of the reference's arrays) into the
port's tensors on a given device, so a run started in one package can
continue in the other.  Training states go both ways: :func:`train_state`
carries a reference ``TrainState`` (or a checkpoint of one, read by
:func:`repro_torch.checkpoint.ckpt.load`) into the port, and
:func:`to_reference` lays the port's out as the reference's, to save a
checkpoint the reference restores; under a mesh (``ctx``) the first
gives each rank its blocks, and the second gathers the blocks whole first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.flitsim import AsymmetricLaneParams, SymmetricFlitParams


def rows(a, device=None) -> torch.Tensor:
    """A row-stacked ``[rows, cells]`` operand or state as a contiguous
    f32 tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    if arr.ndim != 2:
        raise ValueError(f"row-stacked operands are 2-D, got shape "
                         f"{arr.shape}")
    return torch.from_numpy(arr.copy()).to(device_mod.resolve(device))


def _params(cls, fields: Union[Mapping[str, Any], Any], device):
    dev = device_mod.resolve(device)
    get = fields.get if isinstance(fields, Mapping) else \
        (lambda n: getattr(fields, n))
    return cls(*[torch.as_tensor(np.array(get(f.name), np.float32),
                                 device=dev).reshape(-1)
                 for f in dataclasses.fields(cls)])


def symmetric_params(fields, device=None) -> SymmetricFlitParams:
    """A symmetric parameter stack from the reference's stack (or a
    mapping of field name -> ``[P]`` array)."""
    return _params(SymmetricFlitParams, fields, device)


def asymmetric_params(fields, device=None) -> AsymmetricLaneParams:
    """An asymmetric parameter stack from the reference's stack (or a
    mapping of field name -> ``[P]`` array)."""
    return _params(AsymmetricLaneParams, fields, device)


def byte_rows(a, device=None) -> torch.Tensor:
    """A 2-D array of byte values (flit-packing lines, headers, metadata
    or flits) as a contiguous int32 tensor on ``device``; values are kept
    exactly (``rows`` would cast them to f32)."""
    arr = np.asarray(a)
    if arr.ndim != 2 or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"byte arrays are 2-D integer arrays, got "
                         f"{arr.dtype} {arr.shape}")
    if arr.size and (arr.min() < np.iinfo(np.int32).min
                     or arr.max() > np.iinfo(np.int32).max):
        raise ValueError("byte array values do not fit int32")
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    return torch.from_numpy(arr.copy()).to(device_mod.resolve(device))


def _tree(node, dev: torch.device):
    """Nested dicts / tuples of arrays -> the same structure of tensors
    (dtypes kept; bf16 arrives as numpy ``bfloat16`` or f32 and is cast by
    the caller)."""
    if isinstance(node, Mapping):
        return {k: _tree(v, dev) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_tree(v, dev) for v in node)
    if isinstance(node, torch.Tensor):
        return node.to(dev)
    arr = np.asarray(node)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def _unstack(node, i: int):
    if isinstance(node, Mapping):
        return {k: _unstack(v, i) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_unstack(v, i) for v in node)
    if isinstance(node, torch.Tensor):
        return node[i]
    return np.asarray(node)[i]


def _per_layer(n: int, blocks) -> Dict[str, Any]:
    """The reference's ``blocks`` of ``n`` layers (one entry per layer, or
    one stack of ``[L, ...]`` leaves for a scanned homogeneous stack) as
    one entry per layer, ``layer_XX``.  A stack's leaves keep their nesting:
    a dense or moe block's parameters (``attn``, ``mlp`` or ``moe`` with
    ``router``, ``wi``, ``wg``, ``wo``), an encoder or decoder block's (the
    latter with ``lnx`` and ``xattn``), attention caches ``{"k", "v"}``,
    ssm decode caches ``(conv, ssm)`` and enc-dec caches ``{"self": {"k",
    "v"}, "cross": {"k", "v"}}``."""
    names = [f"layer_{i:02d}" for i in range(n)]
    if isinstance(blocks, Mapping) and set(blocks) == set(names):
        return dict(blocks)
    return {name: _unstack(blocks, i) for i, name in enumerate(names)}


def model_params(cfg, tree, device=None) -> Dict[str, Any]:
    """The reference's ``model.init(...)`` parameters (a nested dict of
    numpy arrays) as the port's: the same leaves (``frontend.proj`` of a
    vision model, ``frontend.adapter`` of an encoder-decoder), one
    ``blocks`` entry per layer (an encoder-decoder's ``encoder.blocks``
    and ``decoder.blocks`` each), on ``device``."""
    dev = device_mod.resolve(device)
    out = dict(tree)
    if cfg.is_encdec:
        out["encoder"] = dict(tree["encoder"], blocks=_per_layer(
            cfg.encoder_layers, tree["encoder"]["blocks"]))
        out["decoder"] = dict(tree["decoder"], blocks=_per_layer(
            cfg.num_layers, tree["decoder"]["blocks"]))
    else:
        out["blocks"] = _per_layer(cfg.num_layers, tree["blocks"])
    return _tree(out, dev)


def _field(node, name: str):
    """A NamedTuple field, or a checkpoint's ``.name`` key (absent for the
    error feedback of a state without one)."""
    if isinstance(node, Mapping):
        return node.get("." + name)
    return getattr(node, name)


def train_state(cfg, tree, device=None, ctx=None):
    """The reference's ``TrainState`` (numpy leaves: ``params``, ``opt``
    with ``step``, ``mu``, ``nu``, and ``error_fb`` or None), or the same
    leaves as :func:`repro_torch.checkpoint.ckpt.load` reads them from a
    reference checkpoint, as the port's ``TrainState`` on ``device``:
    stacked ``[L, ...]`` blocks unstacked as :func:`model_params` does,
    values and dtypes kept; under a mesh, this rank's blocks."""
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import active
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState, shard_state
    dev = device_mod.resolve(device)
    opt, efb = _field(tree, "opt"), _field(tree, "error_fb")

    def tensors(node):
        return model_params(cfg, node, dev)
    step = _field(opt, "step")
    state = TrainState(
        params=tensors(_field(tree, "params")),
        opt=AdamWState(step=torch.as_tensor(
            np.array(step) if not isinstance(step, torch.Tensor)
            else step).to(dev, torch.int32),
            mu=tensors(_field(opt, "mu")), nu=tensors(_field(opt, "nu"))),
        error_fb=None if efb is None else tensors(efb))
    return shard_state(state, Model(cfg), ctx) if active(ctx) else state


def _stacked(cfg) -> bool:
    """Whether the reference stacks the layers of ``cfg``'s blocks."""
    return cfg.is_encdec or (cfg.scan_layers and cfg.homogeneous())


def _restack(n: int, blocks):
    """Per-layer ``layer_XX`` entries as one stack of ``[L, ...]`` numpy
    leaves (the reference's scanned layout)."""
    layers = [blocks[f"layer_{i:02d}"] for i in range(n)]

    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([x[k] for x in nodes]) for k in nodes[0]}
        return np.stack([_numpy(x) for x in nodes])
    return stack(layers)


def _numpy(t):
    """A tensor (f32 or integer: a training state has no bf16 leaf) as a
    numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _ref_params(cfg, params):
    out = {k: v for k, v in params.items()}
    if cfg.is_encdec:
        out["encoder"] = dict(params["encoder"], blocks=_restack(
            cfg.encoder_layers, params["encoder"]["blocks"]))
        out["decoder"] = dict(params["decoder"], blocks=_restack(
            cfg.num_layers, params["decoder"]["blocks"]))
    elif _stacked(cfg):
        out["blocks"] = _restack(cfg.num_layers, params["blocks"])

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return _numpy(node)
    return walk(out)


def to_reference(cfg, state, ctx=None):
    """The port's ``TrainState`` in the reference's layout, numpy leaves:
    the blocks of a model the reference scans stacked along ``[L, ...]``
    again.  :func:`repro_torch.checkpoint.ckpt.save` of it writes the
    leaf names the reference's ``ckpt.restore`` looks for.  Under a mesh
    (``state`` the rank's blocks) every rank gathers them whole first."""
    from repro_torch.models.model import Model
    from repro_torch.models.sharding import active
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState, unshard_state
    if active(ctx):
        state = unshard_state(state, Model(cfg), ctx)
    return TrainState(
        params=_ref_params(cfg, state.params),
        opt=AdamWState(step=_numpy(state.opt.step),
                       mu=_ref_params(cfg, state.opt.mu),
                       nu=_ref_params(cfg, state.opt.nu)),
        error_fb=None if state.error_fb is None
        else _ref_params(cfg, state.error_fb))


def decode_caches(cfg, tree, device=None) -> Dict[str, Any]:
    """The reference's decode caches (``prefill`` or ``decode_step``
    output, numpy arrays) as the port's: one entry per layer, attention
    caches ``{"k", "v"}`` in bf16, recurrent states ``(h, conv)``, ssm
    states ``(conv, ssm)``, enc-dec caches ``{"self", "cross"}``."""
    return _tree(_per_layer(cfg.num_layers, tree),
                 device_mod.resolve(device))
