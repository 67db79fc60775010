"""Mixture-of-Experts block: top-k routing with capacity-factor token
dropping and the Switch load-balancing loss (port of
:mod:`repro.models.moe`).

Three branches, as the reference's:

  * one device: ``E_local = E``, rank 0;
  * a mesh with one 'model' rank: the single-device branch on the whole
    batch, as GSPMD runs the reference's (each data rank gathers every
    rank's tokens, routes them all with the global capacity, and keeps
    its rows);
  * expert parallel (``tp > 1``): the expert slabs are split over
    'model' (FSDP-gathered over 'data' where the layer runs), each rank
    routes its data rank's tokens with the whole router, packs the
    (token, choice) pairs of its ``E / tp`` experts with the capacity of
    its local token count, and the ranks' outputs are summed over
    'model'; ``aux`` is the local one (the loss averages it over the data
    ranks, :mod:`repro_torch.models.model`).

The arithmetic follows the reference's, step by step, so that the routing
decisions are the same:

  * the router runs in f32 and the top k experts are taken by a stable
    descending sort: among equal probabilities the lower expert index
    wins, as with ``jax.lax.top_k`` (``torch.topk`` makes no such
    promise);
  * each (token, choice) pair, in token order, takes the next free slot
    of its expert (the exclusive cumsum of the one-hot choices); pairs
    past ``capacity`` are dropped and write to a trash row;
  * the k weighted expert outputs of a token are summed in bf16 in choice
    order, as the reference's scatter-add does (no ``index_add_``: on
    CUDA its order is not fixed).

The expert products are batched matmuls (the reference leaves them to
XLA, outside any Pallas kernel).

Training differentiates the block as autograd sees it: through the gate
weights and ``aux`` into the router, through the expert products into
the expert slabs (the chosen experts and slots are integers, as in the
reference).  A training forward passes a ``routing`` dict: the first
call of a layer records its expert choices there, and the recompute of a
rematerialized layer takes them from it instead of routing again, so the
backward sees the forward's dispatch whatever the rounding of the
recompute.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding
from repro_torch.models.layers import cast
from repro_torch.models.schema import Leaf
from repro_torch.runtime import spans


def moe_schema(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {
        "router": Leaf((d, e), ("embed_act", "experts"), init="normal"),
        "wi": Leaf((e, d, f), ("experts", "embed", "expert_mlp"), fan_axis=1),
        "wo": Leaf((e, f, d), ("experts", "expert_mlp", "embed"), fan_axis=1),
    }
    if cfg.mlp_gated:
        s["wg"] = Leaf((e, d, f), ("experts", "embed", "expert_mlp"),
                       fan_axis=1)
    return s


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots of each expert for a batch of ``tokens`` tokens."""
    c = int(tokens * cfg.experts_per_token * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(8, c)


def router_probs(xt, router_w):
    """xt [T, d] -> the router's probabilities [T, E], f32."""
    return torch.softmax(torch.matmul(xt.float(), router_w.float()), dim=-1)


def route(xt, router_w, cfg: ModelConfig):
    """xt [T, d] -> (probs [T, E] f32, top_w [T, k] f32 normalised,
    top_e [T, k] int64): the k most probable experts of each token in
    descending order, the lower index first among equal probabilities."""
    probs = router_probs(xt, router_w)
    top_e = torch.sort(probs, dim=-1, descending=True,
                       stable=True)[1][:, :cfg.experts_per_token]
    return probs, gate_weights(probs, top_e), top_e


def gate_weights(probs, top_e):
    """The chosen experts' probabilities, normalised to sum to one."""
    top_w = torch.gather(probs, 1, top_e)
    return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)


def dispatch(top_e, num_experts: int, cap: int, is_local=None):
    """top_e [T, k] -> (dest [T*k], keep [T*k] bool): the slot
    ``expert * cap + position`` of each (token, choice) pair in token
    order, ``num_experts * cap`` (the trash row) for a dropped pair.
    With ``is_local`` [T, k] (expert parallel) ``top_e`` holds local
    expert ids, and a pair that is not local is dropped and counts for
    no expert.

    A pair's position is the number of earlier pairs of its expert (the
    reference's exclusive cumsum of the one-hot choices over [T*k, E]):
    here its rank in a stable sort by expert less its expert's first rank,
    the same integers without a scan down a tall [T*k, E] array (on the
    card that scan took half of a 2048-token olmoe-1b-7b prefill)."""
    flat_e = top_e.reshape(-1)
    if is_local is not None:
        flat_e = torch.where(is_local.reshape(-1), flat_e, num_experts)
    order = torch.sort(flat_e, stable=True)[1]
    # a count of each id in [0, num_experts] (``bincount``'s, with a
    # length fixed by the arguments, as fake tensors need)
    counts = torch.zeros(num_experts + 1, dtype=flat_e.dtype,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts
    pos_in_e = torch.empty_like(flat_e)
    pos_in_e[order] = torch.arange(flat_e.numel(), device=flat_e.device) \
        - starts[flat_e[order]]
    keep = pos_in_e < cap
    if is_local is not None:
        keep = keep & is_local.reshape(-1)
    dest = torch.where(keep, flat_e * cap + pos_in_e,
                       torch.full_like(flat_e, num_experts * cap))
    return dest, keep


def moe_local(xt, router_w, wi, wg, wo, cfg: ModelConfig, cap: int,
              routing: Optional[dict] = None, ctx=None):
    """xt [T, d] bf16 -> (out [T, d], aux scalar, dropped share).
    ``routing``: the expert choices ``"top_e"`` [T, k] to take if it holds
    them, else where to record the choices made.  Expert parallel (``wi``
    etc. this rank's ``E / tp`` experts, ``router_w`` whole): ``out`` is
    the local experts' part and ``dropped`` the share of local pairs."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    e_local = wi.shape[0]
    if routing is None:
        probs, top_w, top_e = route(xt, router_w, cfg)
    else:
        # the choices are routed once, outside the graph, so that a
        # recompute saves the same tensors as the forward did
        if "top_e" not in routing:
            with torch.no_grad():
                routing["top_e"] = route(xt, router_w, cfg)[2]
        top_e = routing["top_e"]
        probs = router_probs(xt, router_w)
        top_w = gate_weights(probs, top_e)

    # aux load-balancing loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=xt.device)
    ce.index_add_(0, top_e.reshape(-1),
                  torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                             device=xt.device))
    aux = e * torch.sum(me * ce)

    is_local = None
    if e_local != e:
        # the router's work is repeated on every 'model' rank; the expert
        # path's gradients (into the tokens and the gate weights) are each
        # rank's part of the whole
        local_e = top_e - ctx.tp_index() * e_local
        is_local = (local_e >= 0) & (local_e < e_local)
        top_e = torch.where(is_local, local_e, 0)
        xt = sharding.enter_tp(xt, ctx)
        top_w = sharding.enter_tp(top_w, ctx)
    dest, keep = dispatch(top_e, e_local, cap, is_local)
    tok = torch.arange(t * k, device=xt.device) // k
    xe = torch.zeros((e_local * cap + 1, d), dtype=xt.dtype,
                     device=xt.device)
    # kept slots are written once; dropped pairs write zeros to the trash
    xe[dest] = torch.where(keep[:, None], xt[tok], xt.new_zeros(()))
    xe = xe[:-1].reshape(e_local, cap, d)

    h = torch.bmm(xe, cast(wi))
    if wg is not None:
        h = F.silu(torch.bmm(xe, cast(wg))) * h
    else:
        h = F.gelu(h, approximate="tanh")
    ye = torch.bmm(h, cast(wo))

    ye_flat = torch.cat([ye.reshape(e_local * cap, d),
                         ye.new_zeros((1, d))])
    contrib = ye_flat[dest] * (top_w.reshape(-1) * keep).to(
        ye.dtype)[:, None]
    contrib = contrib.reshape(t, k, d)
    out = contrib[:, 0]
    for j in range(1, k):                    # bf16 sums in choice order
        out = out + contrib[:, j]

    pairs = t * k if is_local is None else \
        torch.clamp(is_local.sum().float(), min=1.0)
    dropped = 1.0 - keep.float().sum() / pairs
    return out.to(xt.dtype), aux, dropped


def _count_drops(dropped, pairs: int) -> None:
    """``moe.pairs`` and ``moe.dropped_pairs`` (``moe_local``'s share
    times its pairs, on the device) while spans record."""
    if spans.on():
        spans.add("moe.pairs", pairs)
        spans.add_device("moe.dropped_pairs", dropped.detach() * pairs)


def moe_block(params, x, cfg: ModelConfig, routing: Optional[dict] = None,
              ctx=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar).  ``routing``: a
    layer's expert choices of one training step (``"top_e"``), recorded
    at its first call and reused by its recompute.  Under a mesh ``x`` is
    the data rank's rows and the expert slabs its 'model' block."""
    b, s, d = x.shape
    args = (params["wi"], params.get("wg"), params["wo"], cfg)
    k = cfg.experts_per_token
    if not sharding.active(ctx) or (ctx.tp_size() == 1
                                    and ctx.dp_size() == 1):
        out, aux, dropped = moe_local(x.reshape(b * s, d), params["router"],
                                      *args, capacity(b * s, cfg), routing)
        _count_drops(dropped, b * s * k)
        return out.reshape(b, s, d), aux
    if ctx.tp_size() == 1:
        xg = sharding.gather_dp(x, ctx, 0)
        out, aux, dropped = moe_local(xg.reshape(-1, d), params["router"],
                                      *args, capacity(xg.shape[0] * s, cfg),
                                      routing)
        _count_drops(dropped, xg.shape[0] * s * k)
        i = ctx.index_of(ctx.dp_axes)
        return out.reshape(xg.shape)[i * b:(i + 1) * b], aux
    if cfg.num_experts % ctx.tp_size():
        raise ValueError(f"{cfg.name}: {cfg.num_experts} experts do not "
                         f"split over {ctx.tp_size()} 'model' ranks")
    router = sharding.gather_tp(params["router"], ctx, 1)
    # expert parallel: ``moe_local``'s share is of the rank's own pairs,
    # whose number it keeps, so the counters leave this branch out
    out, aux, _ = moe_local(x.reshape(b * s, d), router, *args,
                            capacity(b * s, cfg), routing, ctx)
    out = sharding.leave_tp(out.float(), ctx).to(x.dtype)
    return out.reshape(b, s, d), aux
