"""Sharding context, logical-axis rules, placements and the collectives of
the multi-device path (port of :mod:`repro.models.sharding`).

Parameters and activations carry *logical* axis names; a ``ShardingCtx``
maps them to mesh axes with the reference's divisibility guards
(:meth:`ShardingCtx.spec`: a tuple equal, entry for entry, to the
reference's ``PartitionSpec``).  The same model code runs

  * on one device                           — ctx = None or ShardingCtx()
  * on a mesh of ranks (``launch.mesh``)    — ctx = from_mesh(mesh)

Mesh contract (the reference's):
  'model' — tensor parallel (heads / ffn / vocab / experts)
  'data'  — FSDP parameter dim + batch
  'pod'   — pure data parallel (gradient all-reduce only)

What GSPMD does for the reference is explicit here.  A rank holds the
block of each leaf its spec gives it (:func:`shard`, :func:`block`).  Along
'model' every activation of the residual stream is replicated, and the
model keeps one rule: a replicated value that enters rank-specific work
passes :func:`enter_tp` (identity forward, gradients summed over 'model'
backward), and partial sums leave it by :func:`leave_tp` (summed forward,
identity backward).  So a replicated parameter gets its whole gradient on
every 'model' rank and a 'model'-sharded one its block's.  Along the data
axes each rank takes its rows of the batch; FSDP leaves are gathered over
'data' where a layer runs (:func:`fsdp`, whose backward sums and slices
the gradient, a reduce-scatter), the loss's sums are all-reduced
(:func:`reduce_dp`), and :func:`reduce_grads` sums the rest of the
gradients over the data axes a leaf is not sharded on.

Under ``ctx.sequence_parallel`` the residual stream between the
tensor-parallel regions holds this rank's ``S / tp`` positions where they
divide (:func:`seq_split`, the reference's ``("batch", "seq",
"embed_act")`` rule and its divisibility guard): a region is entered by
gathering the positions (:func:`enter_region`) and left by keeping the
rank's own of the summed output (:func:`leave_region`); the norms that
run on the rank's positions take their scales through
:func:`stream_params`.  The regions' own collectives are unchanged, so a
region's exit is its all-reduce and a slice (the reference's
reduce-scatter) and its entry's backward the all-reduce of ``enter_tp``
and a slice; the stream's values equal those without sequence
parallelism.  :data:`residual` records the stream's shape and bytes on
this rank.

Every collective is an ``all_reduce`` (sum or max) or a list
``all_gather``: the two that NCCL and gloo both take on every dtype here.
Under gloo (the CPU, or ranks sharing a card) a CUDA tensor is staged
through host memory.  A mesh whose backend is ``"loopback"``
(:func:`repro_torch.launch.mesh.loopback_mesh`) has one process and no
process group: it traces one rank of a larger mesh, every collective
returns its result's shape with this rank's values
(:func:`loopback_collective`, an operator that fake tensors pass
through).  :data:`traffic` counts the bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

# logical axis -> mesh axes (None = replicated)
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "batch": "__dp__",          # expands to ('pod','data') / ('data',)
    "seq": "__seq__",           # tp-sharded under sequence-parallelism
    "seq_kv": "__tp__",         # KV-cache length (context parallel decode)
    "vocab": "__tp__",
    "embed": "__fsdp__",        # FSDP parameter dim
    "embed_act": None,          # activation feature dim stays replicated
    "heads": "__tp__",
    "kv_heads": "__tp__",
    "attn_q_seq": "__tp__",     # q-seq sharding when head counts don't divide
    "head_dim": None,
    "mlp": "__tp__",
    "experts": "__tp__",
    "expert_mlp": None,
    "layers": None,
    "lru": "__tp__",
    "ssm_inner": "__tp__",
    "ssm_state": None,
    "conv": None,
    "norm": None,
}

#: one entry of a spec: replicated, one mesh axis, or several
Entry = Optional[object]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Optional[Any] = None              # repro_torch.launch.mesh.Mesh
    dp_axes: Tuple[str, ...] = ()           # ('pod','data') or ('data',)
    tp_axis: Optional[str] = None           # 'model'
    fsdp_axis: Optional[str] = None         # 'data'
    rules: Optional[Dict[str, Optional[str]]] = None
    sequence_parallel: bool = False
    #: disable the flat-head attention constraint (baseline reproduction)
    force_seq_attn: bool = False

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    def axis_size(self, name: str) -> int:
        if not self.enabled:
            return 1
        return self.mesh.shape[name]

    def dp_size(self) -> int:
        return int(math.prod([self.axis_size(a) for a in self.dp_axes])) \
            or 1

    def tp_size(self) -> int:
        return self.axis_size(self.tp_axis) if self.tp_axis else 1

    def _resolve(self, logical: Optional[str]):
        """Logical axis -> mesh axis (or tuple), before divisibility checks."""
        if logical is None or not self.enabled:
            return None
        rules = dict(DEFAULT_RULES)
        if self.rules:
            rules.update(self.rules)
        tgt = rules.get(logical)
        if tgt == "__dp__":
            return self.dp_axes if self.dp_axes else None
        if tgt == "__tp__":
            return self.tp_axis
        if tgt == "__fsdp__":
            return self.fsdp_axis
        if tgt == "__seq__":
            return self.tp_axis if self.sequence_parallel else None
        return tgt

    def spec(self, axes: Tuple[Optional[str], ...],
             shape: Optional[Tuple[int, ...]] = None) -> Spec:
        """The mesh axes of each dimension, from logical axes, dropping
        non-divisible, over-subscribed, or duplicate-axis assignments to
        replication; trailing ``None``s dropped (a ``PartitionSpec``'s
        entries)."""
        out = []
        used: set = set()
        for i, logical in enumerate(axes):
            mesh_axes = self._resolve(logical)
            if mesh_axes is None:
                out.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes_t = (mesh_axes,)
            else:
                mesh_axes_t = tuple(mesh_axes)
            if any(a in used for a in mesh_axes_t):
                out.append(None)            # a mesh axis may appear once
                continue
            if shape is not None:
                total = int(math.prod([self.axis_size(a)
                                       for a in mesh_axes_t]))
                if total == 0 or shape[i] % total != 0:
                    out.append(None)
                    continue
            used.update(mesh_axes_t)
            out.append(mesh_axes_t[0] if len(mesh_axes_t) == 1
                       else mesh_axes_t)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    # -- the live mesh ------------------------------------------------------
    def size_of(self, axes) -> int:
        return int(math.prod(self.axis_size(a) for a in _axes(axes)))

    def index_of(self, axes, rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) index along ``axes`` (row-major in
        their order)."""
        c = self.mesh.coords(rank)
        i = 0
        for a in _axes(axes):
            i = i * self.mesh.shape[a] + c[a]
        return i

    def tp_index(self) -> int:
        return self.index_of(self.tp_axis) if self.tp_size() > 1 else 0


def from_mesh(mesh, sequence_parallel: bool = False,
              rules: Optional[Dict[str, Optional[str]]] = None,
              force_seq_attn: bool = False) -> ShardingCtx:
    names = mesh.axis_names
    if "pod" in names:
        dp_axes: Tuple[str, ...] = ("pod", "data")
    else:
        dp_axes = ("data",)
    return ShardingCtx(mesh=mesh, dp_axes=dp_axes,
                       tp_axis="model" if "model" in names else None,
                       fsdp_axis="data" if "data" in names else None,
                       rules=rules, sequence_parallel=sequence_parallel,
                       force_seq_attn=force_seq_attn)


def active(ctx: Optional[ShardingCtx]) -> bool:
    return ctx is not None and ctx.enabled


def _axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


# -- placement ------------------------------------------------------------------

def block(shape: Tuple[int, ...], spec: Spec, ctx: ShardingCtx,
          rank: Optional[int] = None) -> Tuple[slice, ...]:
    """This rank's (or ``rank``'s) slice of each dimension of a leaf of
    ``shape``."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        parts = ctx.size_of(entry)
        step = n // parts
        j = ctx.index_of(entry, rank)
        out.append(slice(j * step, (j + 1) * step))
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Spec,
                ctx: ShardingCtx) -> Tuple[int, ...]:
    return tuple(n // (ctx.size_of(spec[i]) if i < len(spec)
                       and spec[i] is not None else 1)
                 for i, n in enumerate(shape))


def shard(full: torch.Tensor, spec: Spec, ctx: ShardingCtx) -> torch.Tensor:
    """This rank's block of ``full`` (a contiguous copy)."""
    return full[block(tuple(full.shape), spec, ctx)].clone()


def unshard(local: torch.Tensor, spec: Spec, ctx: ShardingCtx,
            device=None) -> torch.Tensor:
    """The whole leaf from every rank's block (all-gathers; no graph), on
    ``device`` (default: the block's).  Under gloo a leaf bound for the
    host is gathered there (no copy back to the card)."""
    out = local.detach()
    if device is not None and ctx.mesh.backend == "gloo":
        out = out.to(device)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out = all_gather(out, ctx, entry, dim)
    return out if device is None else out.to(device)


def gather_to(local: torch.Tensor, spec: Spec, ctx: ShardingCtx,
              device=None) -> Optional[torch.Tensor]:
    """The whole leaf from every rank's block on rank 0 alone (one
    ``gather`` over the mesh, no graph; the other ranks get ``None``), on
    ``device`` (default: the block's).  Under gloo the blocks travel
    through host memory, and a leaf bound for the host stays there."""
    out = local.detach()
    rank0 = ctx.mesh.rank == 0
    if not any(e is not None for e in spec):
        return out if rank0 else None
    g = ctx.mesh.group(ctx.mesh.axis_names)
    src = _payload(out, ctx)
    parts = [torch.empty_like(src) for _ in range(g.size)] if rank0 \
        else None
    dist.gather(src, parts, dst=0, group=g.group)
    if not rank0:
        return None
    shape = tuple(n * (ctx.size_of(spec[i]) if i < len(spec)
                       and spec[i] is not None else 1)
                  for i, n in enumerate(out.shape))
    whole = src.new_empty(shape)
    for r, part in enumerate(parts):
        whole[block(shape, spec, ctx, r)] = part
    return whole.to(device if device is not None else local.device)


def gather_tree_to(tree, specs, ctx: ShardingCtx, device=None):
    """:func:`gather_to` of every leaf (``None`` leaves off rank 0)."""
    return map_specs(lambda t, s: gather_to(t, s, ctx, device), tree, specs)


def tree_specs(schema, ctx: ShardingCtx):
    """The spec of every leaf of a schema (nested dicts of ``Leaf``)."""
    if isinstance(schema, dict):
        return {k: tree_specs(v, ctx) for k, v in schema.items()}
    return ctx.spec(schema.axes, schema.shape)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over nested dicts (and tuples) of tensors and
    their specs."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def map_tree(fn, tree):
    """``fn(leaf)`` over nested dicts and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, t) for t in tree)
    return fn(tree)


def cache_spec(shape: Tuple[int, ...], ctx: ShardingCtx) -> Spec:
    """The spec of one layer's decode-cache leaf of ``shape`` (global):
    the reference's rule for its caches (``Model.input_shardings``) less
    its leading ``"layers"`` entry: the batch over the data axes and, on a
    4-D leaf, axis 1 on ``"seq_kv"`` (a KV cache's positions, an SSM
    state's heads)."""
    axes = ["batch"] + [None] * (len(shape) - 1)
    if len(shape) == 4:
        axes[1] = "seq_kv"
    return ctx.spec(tuple(axes), shape)


def shard_tree(tree, specs, ctx: ShardingCtx):
    return map_specs(lambda t, s: shard(t, s, ctx), tree, specs)


def unshard_tree(tree, specs, ctx: ShardingCtx, device=None):
    return map_specs(lambda t, s: unshard(t, s, ctx, device), tree, specs)


def sharded_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for e in spec if e is not None for a in _axes(e))


# -- collectives ------------------------------------------------------------------

#: bytes of each kind of collective on this rank since :func:`reset_traffic`
#: (an all-reduce counts its tensor, an all-gather its gathered result)
#: and the number of calls
traffic: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "calls": 0}


def reset_traffic() -> None:
    for k in traffic:
        traffic[k] = 0


def transport(ctx: ShardingCtx, device: torch.device) -> str:
    """How a collective moves tensors on ``device``: ``"device"``, or
    ``"host-staged"`` (gloo and a CUDA tensor)."""
    if ctx.mesh.backend == "gloo" and device.type == "cuda":
        return "host-staged"
    return "device"


@torch.library.custom_op("repro_torch::loopback_collective",
                        mutates_args=())
def loopback_collective(t: torch.Tensor, kind: str, parts: int,
                        dim: int) -> torch.Tensor:
    """A loopback mesh's collective: ``"all_reduce"`` gives ``t`` back,
    ``"all_gather"`` ``parts`` copies of it along ``dim`` (the shapes of
    the real ones; the values of a world whose ranks all hold ``t``)."""
    if kind == "all_gather":
        return torch.cat([t] * parts, dim=dim)
    return t.clone()


@loopback_collective.register_fake
def _(t, kind, parts, dim):
    if kind == "all_gather":
        shape = list(t.shape)
        shape[dim] *= parts
        return t.new_empty(shape)
    return torch.empty_like(t)


def _loopback(ctx: ShardingCtx) -> bool:
    return ctx.mesh.backend == "loopback"


def _payload(t: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """A contiguous copy of ``t`` that the backend's collectives take."""
    if transport(ctx, t.device) == "host-staged":
        return t.detach().to("cpu", copy=True)
    return t.detach().contiguous().clone()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, ctx: ShardingCtx, axes,
               op: str = "sum") -> torch.Tensor:
    """The ``op`` of ``t`` over the ranks of ``axes`` (a new tensor)."""
    g = ctx.mesh.group(axes)
    if g.size == 1:
        return t.detach()
    if _loopback(ctx):
        buf = loopback_collective(t.detach(), "all_reduce", g.size, 0)
    else:
        buf = _payload(t, ctx)
        dist.all_reduce(buf, op=_OPS[op], group=g.group)
    traffic["all_reduce"] += buf.numel() * buf.element_size()
    traffic["calls"] += 1
    return buf.to(t.device)


def all_gather(t: torch.Tensor, ctx: ShardingCtx, axes,
               dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``axes`` concatenated along ``dim`` in rank
    order."""
    g = ctx.mesh.group(axes)
    if g.size == 1:
        return t.detach()
    if _loopback(ctx):
        out = loopback_collective(t.detach(), "all_gather", g.size,
                                  dim % t.ndim)
    else:
        src = _payload(t, ctx)
        parts = [torch.empty_like(src) for _ in range(g.size)]
        dist.all_gather(parts, src, group=g.group)
        out = torch.cat(parts, dim=dim)
    traffic["all_gather"] += out.numel() * out.element_size()
    traffic["calls"] += 1
    return out.to(t.device)


def _own(t: torch.Tensor, ctx: ShardingCtx, axes, dim: int):
    g = ctx.mesh.group(axes)
    n = t.shape[dim] // g.size
    return t.narrow(dim, g.index * n, n)


def sum_own(t: torch.Tensor, ctx: ShardingCtx, axes,
            dim: int) -> torch.Tensor:
    """This rank's part (along ``dim``) of the sum of ``t`` over the ranks
    of ``axes``: a reduce-scatter, as an all-reduce and a slice (staged,
    only the slice goes back to the card)."""
    g = ctx.mesh.group(axes)
    if g.size == 1:
        return t.detach()
    if _loopback(ctx):
        return _own(all_reduce(t, ctx, axes), ctx, axes, dim).contiguous()
    buf = _payload(t, ctx)
    dist.all_reduce(buf, group=g.group)
    traffic["all_reduce"] += buf.numel() * buf.element_size()
    traffic["calls"] += 1
    return _own(buf, ctx, axes, dim).to(t.device, copy=True)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.args = (ctx, axes)
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(g, *fctx.args), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        return all_reduce(x, ctx, axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim, summed):
        fctx.args = (ctx, axes, dim, summed)
        return all_gather(x, ctx, axes, dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axes, dim, summed = fctx.args
        own = sum_own(g, ctx, axes, dim) if summed else \
            _own(g, ctx, axes, dim).contiguous()
        return own, None, None, None, None


def enter_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    """A replicated value entering rank-specific work on 'model':
    identity forward, its gradient summed over 'model' backward."""
    if not active(ctx) or ctx.tp_size() == 1:
        return x
    return _Enter.apply(x, ctx, ctx.tp_axis)


def leave_tp(x: torch.Tensor, ctx) -> torch.Tensor:
    """Partial sums over 'model' summed (forward; pass f32 so the sum
    rounds once); the gradient passes as it is (backward)."""
    if not active(ctx) or ctx.tp_size() == 1:
        return x
    return _Reduce.apply(x, ctx, ctx.tp_axis)


def gather_tp(x: torch.Tensor, ctx, dim: int,
              summed: bool = False) -> torch.Tensor:
    """Each 'model' rank's part of a value all-gathered along ``dim``.
    Backward, the rank's part of the gradient: of the replicated gradient
    where the gathered value is used replicated, or (``summed``, where each
    rank uses parts of it of its own) of the ranks' gradients summed over
    'model' (a reduce-scatter)."""
    if not active(ctx) or ctx.tp_size() == 1:
        return x
    return _Gather.apply(x, ctx, ctx.tp_axis, dim, summed)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.args = (ctx, axes, dim)
        return _own(x, ctx, axes, dim).contiguous()

    @staticmethod
    def backward(fctx, g):
        return all_gather(g, *fctx.args), None, None, None


#: the residual stream of the last forward on this rank: its shape and
#: bytes (``S / tp`` positions under sequence parallelism)
residual: Dict[str, Any] = {"shape": None, "bytes": 0}


def seq_split(n: int, ctx) -> bool:
    """Whether a residual stream of ``n`` positions holds ``n / tp`` of
    them a rank: ``ctx.sequence_parallel`` and ``"seq"``'s spec
    (:meth:`ShardingCtx.spec`'s divisibility guard; decode's one position
    and a ragged length stay replicated)."""
    return active(ctx) and ctx.sequence_parallel and tp_split(n, ctx, "seq")


def enter_region(h: torch.Tensor, ctx, sp: bool) -> torch.Tensor:
    """A block's normed input entering its tensor-parallel region: where
    the stream is sequence parallel (``sp``), the 'model' ranks' positions
    gathered along dim 1; backward, the rank's positions of the region's
    gradient, which ``enter_tp`` inside the region made whole."""
    return gather_tp(h, ctx, 1) if sp else h


def leave_region(o: torch.Tensor, ctx, sp: bool) -> torch.Tensor:
    """A replicated ``[B, S, ...]`` value (a region's output, the
    embeddings) as the residual stream holds it: where ``sp``, the rank's
    own ``S / tp`` positions; backward, the ranks' gradients gathered (the
    replicated gradient the value's producer takes)."""
    return _Scatter.apply(o, ctx, ctx.tp_axis, 1) if sp else o


def stream_params(p, ctx, sp: bool):
    """Replicated parameters applied to a sequence-parallel stream's own
    positions (the norms' scales, ``sp``): each rank's positions give part
    of their gradient, summed over 'model' backward (:func:`enter_tp`)."""
    return map_tree(lambda t: enter_tp(t, ctx), p) if sp else p


def note_stream(x: torch.Tensor) -> None:
    residual["shape"] = tuple(x.shape)
    residual["bytes"] = x.numel() * x.element_size()


def tp_split(n: int, ctx, logical: str = "seq_kv") -> bool:
    """Whether a dimension of ``n`` on ``logical`` splits over 'model'
    (the rules and the divisibility guard of :meth:`ShardingCtx.spec`)."""
    return active(ctx) and ctx.tp_size() > 1 and \
        ctx.spec((logical,), (n,)) == (ctx.tp_axis,)


def own_block(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """This 'model' rank's block of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // ctx.tp_size()
    return x.narrow(dim, ctx.tp_index() * n, n)


def batch_rows(ctx, batch: int):
    """``(ctx, rows)`` of an inference forward on a global batch of
    ``batch`` rows: this rank's rows where they divide over the data axes
    (the spec of ``"batch"``), else every row, with a ctx whose batch is
    not split (no data axes)."""
    if not active(ctx):
        return ctx, slice(None)
    spec = ctx.spec(("batch",), (batch,))
    if not spec:
        return dataclasses.replace(ctx, dp_axes=()), slice(None)
    return ctx, block((batch,), spec, ctx)[0]


def gather_rows(x: torch.Tensor, ctx) -> torch.Tensor:
    """The data ranks' rows of an inference result gathered along dim 0
    (no graph; ``x`` as it is where the batch is not split)."""
    if not active(ctx) or ctx.dp_size() == 1:
        return x
    return all_gather(x, ctx, ctx.dp_axes, 0)


def reduce_dp(x: torch.Tensor, ctx) -> torch.Tensor:
    """A sum over the data axes (forward) whose gradient passes to each
    rank's own term (backward): the loss's sums."""
    if not active(ctx) or ctx.dp_size() == 1:
        return x
    return _Reduce.apply(x, ctx, ctx.dp_axes)


def gather_dp(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """The data ranks' rows gathered along ``dim`` for work every data
    rank repeats on all of them: the gradient is summed over the data axes
    and sliced backward."""
    if not active(ctx) or ctx.dp_size() == 1:
        return x
    return _Gather.apply(x, ctx, ctx.dp_axes, dim, True)


def fsdp(tree, specs, ctx):
    """The leaves of ``tree`` with their FSDP dimension gathered over
    'data' (a leaf keeps its 'model' block); backward, each rank's block
    of the gradient summed over 'data' (a reduce-scatter)."""
    if not active(ctx) or ctx.fsdp_axis is None or \
            ctx.axis_size(ctx.fsdp_axis) == 1:
        return tree

    def gather(t, spec):
        for dim, entry in enumerate(spec):
            if entry is not None and ctx.fsdp_axis in _axes(entry):
                t = _Gather.apply(t, ctx, entry, dim, True)
        return t
    return map_specs(gather, tree, specs)


def reduce_grads(grads, specs, ctx):
    """Each gradient leaf summed over the data axes it is not sharded on
    (those it is sharded on were summed by its gather's backward)."""
    if not active(ctx):
        return grads

    def red(g, spec):
        axes = tuple(a for a in ctx.dp_axes if a not in sharded_axes(spec)
                     and ctx.axis_size(a) > 1)
        return all_reduce(g, ctx, axes) if axes else g
    return map_specs(red, grads, specs)


def reduce_over_shards(value: torch.Tensor, spec: Spec, ctx,
                       op: str = "sum") -> torch.Tensor:
    """A per-rank reduction of a leaf's block (its sum of squares, its
    max) completed over the axes the leaf is sharded on."""
    if not active(ctx):
        return value
    axes = tuple(a for a in sharded_axes(spec) if ctx.axis_size(a) > 1)
    return all_reduce(value, ctx, axes, op) if axes else value
