"""Parameter schema: shapes, logical axes and initialisers of every
parameter leaf (port of :mod:`repro.models.schema`).

The leaves keep the reference's shapes and logical axis names, so a
parameter of the reference maps onto the port's by name
(:func:`repro_torch.convert.model_params`).  Values are drawn from a
``torch.Generator`` on the target device: they differ from the
reference's ``jax.random`` values, and parity tests carry the reference's
parameters across instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]         # logical axis names per dim
    init: str = "fan_in"                    # fan_in | normal | zeros | ones
    dtype: torch.dtype = torch.float32
    fan_axis: int = 0                       # which dim is fan-in for scaling

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Schema = Dict[str, Any]          # nested dict of Leaf


def leaves(schema: Schema, prefix: str = "") -> Iterator[Tuple[str, Leaf]]:
    """``(dotted path, leaf)`` of every leaf, keys in sorted order (the
    reference's pytree order)."""
    for key in sorted(schema):
        node = schema[key]
        path = f"{prefix}{key}"
        if isinstance(node, Leaf):
            yield path, node
        else:
            yield from leaves(node, path + ".")


def _init(leaf: Leaf, gen: torch.Generator, device) -> torch.Tensor:
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "normal":
        std = 0.02
    else:                                   # fan_in scaled
        fan = leaf.shape[leaf.fan_axis] if leaf.shape else 1
        std = 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(leaf.dtype)


def init_params(schema: Schema, gen: torch.Generator,
                device) -> Dict[str, Any]:
    """A nested dict of tensors on ``device`` with the schema's structure,
    drawn from ``gen`` (a generator on the same device) leaf by leaf."""
    def _walk(node):
        if isinstance(node, Leaf):
            return _init(node, gen, device)
        return {k: _walk(node[k]) for k in sorted(node)}
    return _walk(schema)


def param_count(schema: Schema) -> int:
    return int(sum(math.prod(leaf.shape) for _, leaf in leaves(schema)))
