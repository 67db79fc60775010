"""The model's weights, made on the device from the seed.

One ``normal_`` call on a ``torch.Generator`` of the device fills a flat
f32 buffer as long as all the parameters together; each parameter is a
view of it, in the layout ``Model.init`` gives (the schema's nested dict,
f32, as the port stores and serves its weights), scaled in place as the
schema's initialiser says.  The same seed gives the same weights, and the
port and the reference are handed the same tensors.

A configuration file's ``init`` object may replace the initialiser of the
leaves of one name (the last part of their path) with the published
model's, transforming the same normal draws ``z``:

* ``{"scale": s}``: the schema's initialiser times ``s``;
* ``{"uniform": [lo, hi]}``: ``u = lo + (hi - lo) Phi(z)``, uniform in
  ``[lo, hi]``;
* ``{"log_of_uniform": [lo, hi]}``: ``log(u)``, ``u`` as above;
* ``{"inv_softplus_of_log_uniform": [lo, hi]}``: ``softplus^-1(u)``,
  ``log u`` uniform in ``[log lo, log hi]``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch


def _uniform(z: torch.Tensor) -> torch.Tensor:
    """Phi(z): the normal draws made uniform in (0, 1)."""
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def _published(t: torch.Tensor, rule: Dict[str, Any]) -> None:
    """Apply ``rule`` (see the module's doc) to ``t`` in place; ``t``
    holds the schema's initialiser, or normal draws where the schema
    fills a constant."""
    if "scale" in rule:
        t.mul_(float(rule["scale"]))
    elif "uniform" in rule:
        lo, hi = rule["uniform"]
        t.copy_(lo + (hi - lo) * _uniform(t))
    elif "log_of_uniform" in rule:
        lo, hi = rule["log_of_uniform"]
        t.copy_(torch.log(lo + (hi - lo) * _uniform(t)))
    elif "inv_softplus_of_log_uniform" in rule:
        lo, hi = (math.log(v) for v in rule["inv_softplus_of_log_uniform"])
        u = torch.exp(lo + (hi - lo) * _uniform(t))
        t.copy_(u + torch.log(-torch.expm1(-u)))
    else:
        raise ValueError(f"unknown initialiser {rule}")


def make_weights(model, seed: int, device,
                 init: Dict[str, Any] = None) -> Dict[str, Any]:
    from repro_torch.models import schema as schema_mod
    leaves = list(schema_mod.leaves(model.schema))
    total = sum(math.prod(leaf.shape) for _, leaf in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    params: Dict[str, Any] = {}
    off = 0
    for path, leaf in leaves:
        if leaf.dtype is not torch.float32:
            raise ValueError(f"{path}: weights are made in f32, the leaf "
                             f"is {leaf.dtype}")
        n = math.prod(leaf.shape)
        t = flat[off:off + n].view(leaf.shape)
        off += n
        rule = (init or {}).get(path.split(".")[-1])
        if rule is not None and "scale" not in rule:
            _published(t, rule)
        elif leaf.init == "zeros":
            t.zero_()
        elif leaf.init == "ones":
            t.fill_(1.0)
        elif leaf.init == "normal":
            t.mul_(0.02)
        else:
            fan = leaf.shape[leaf.fan_axis] if leaf.shape else 1
            t.mul_(1.0 / math.sqrt(max(fan, 1)))
        if rule is not None and "scale" in rule:
            _published(t, rule)
        node = params
        *parents, key = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = t
    return params
