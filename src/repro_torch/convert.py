"""Carry the JAX reference's state across to the port.

The reference keeps its flit-simulator state as parameter stacks
(``SymmetricFlitParams`` / ``AsymmetricLaneParams`` whose fields are
``[P]`` arrays) and row-stacked ``[rows, cells]`` kernel operands and
states, and its flit-packing data path as int32 byte arrays.  These
helpers turn numpy copies of either (``np.asarray`` of the reference's
arrays) into the port's tensors on a given device, so a run started in
one package can continue in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Union

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
