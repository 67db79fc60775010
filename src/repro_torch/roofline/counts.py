"""FLOP, byte and collective counts of a traced step: the port's
counterpart of :mod:`repro.roofline.hlo_parse`, which parses the compiled
HLO of the reference's step.

:class:`Counter` is a ``TorchDispatchMode``: entered inside a
``FakeTensorMode`` it sees every aten operator of rank 0's program (the
forward, autograd's backward and the optimizer) on fake tensors, which
hold shapes and no memory, and it counts with the reference's rules:

  * **FLOPs**: 2 x output elements x contraction for every matmul-class
    operator (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``,
    ``convolution``); nothing for elementwise operators.  A kernel's
    operator (``repro_torch::flash_attention_fwd``, ``ssd_scan``,
    ``rglru_scan``) counts by the formula its wrapper registers
    (:func:`register_formula`).
  * **Bytes** by the reference's fusion rule (``hlo_parse.py``): views
    move nothing; the result of an elementwise or layout operator is
    written only where a non-elementwise operator reads it or nothing
    reads it (an output of the step); every other result is written; an
    operand is read where its producer's result is written (inputs and
    parameters are).  Reads and writes are counted apart (the reference
    splits one total by XLA's output fraction).  An indexed write into a
    tensor (``index_put_``, ``scatter``) counts its update twice, as the
    reference counts a dynamic-update-slice.
  * **Collectives**: the operand bytes of each loopback collective
    (:func:`repro_torch.models.sharding.loopback_collective`), by kind.
    The port's reduce-scatter (``sharding.sum_own``) is an all-reduce and
    a slice: its operand bytes are the reference's reduce-scatter's, under
    ``all_reduce``.
  * **Peak**: the high-water mark of live fake-tensor bytes over the
    trace (distinct storages, the counted step's inputs included): the
    stand-in for XLA's ``temp_size_in_bytes``, labelled as such.

Nothing here allocates device memory or launches a kernel: a kernel
wrapper given a fake tensor calls its operator, whose fake
implementation gives the output's shape (:func:`is_fake`).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakTensorKeyDictionary

#: operator name -> ``fn(args) -> FLOPs`` for the kernels' operators
_FORMULAS: Dict[str, Callable[..., float]] = {}

#: elementwise and layout operators beyond those tagged pointwise: their
#: results fuse into their consumers (the reference's ``_FUSIBLE``)
_LAYOUT = {
    "_to_copy", "clone", "copy", "copy_", "cat", "stack",
    "constant_pad_nd", "flip", "roll", "repeat", "fill", "fill_", "zero_",
    "zeros", "ones", "full", "empty", "empty_like", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
    "new_empty", "new_empty_strided", "empty_strided", "arange",
    "scalar_tensor", "lift_fresh_copy", "where",
    "masked_fill", "masked_fill_", "expand_copy", "tril", "triu",
    "repeat_interleave", "slice_scatter", "select_scatter", "resize_",
    "set_", "detach_",
}
#: operators that return their input's data under another shape, as views
#: do (not flagged as views in their schemas)
_ALIASES = {"_unsafe_view", "lift_fresh", "_reshape_alias"}
#: indexed writes: the update counted twice, nothing else
_INDEXED_WRITES = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
                   "scatter_": 2, "scatter": 2, "scatter_add_": 2,
                   "scatter_add": 2, "index_add_": 2, "index_add": 2,
                   "index_copy_": 2, "index_copy": 2}
_COLLECTIVE = "loopback_collective"


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (a kernel wrapper then calls its
    operator instead of launching)."""
    return isinstance(t, FakeTensor)


def register_formula(name: str, fn: Callable[..., float]) -> None:
    """``fn(*args)`` gives the FLOPs of one call of the operator ``name``
    (``namespace::op``) from its arguments."""
    _FORMULAS[name] = fn


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args) -> float:
    if name in ("mm", "bmm", "addmm", "baddbmm"):
        a, b = args[-2:] if name in ("mm", "bmm") else args[1:3]
        rows = a.numel() // a.shape[-1]
        return 2.0 * rows * b.shape[-1] * a.shape[-1]
    if name == "mv":
        return 2.0 * args[0].numel()
    if name == "dot":
        return 2.0 * args[0].numel()
    return 0.0


def _conv_flops(args, out) -> float:
    """2 x output elements x (input channels a group x kernel size): the
    weight is ``[C_out, C_in / groups, *kernel]``."""
    w = args[1]
    return 2.0 * out.numel() * (w.numel() // w.shape[0])


@dataclasses.dataclass
class Counts:
    """Per-chip counts of one traced program."""
    flops: float = 0.0
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: high-water mark of live fake-tensor bytes (stands in for XLA's
    #: temp_size_in_bytes; includes the step's inputs)
    peak_live_bytes: float = 0.0
    #: calls of each kernel operator
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0

    def add(self, other: "Counts", scale: float = 1.0) -> None:
        self.flops += scale * other.flops
        self.read_bytes += scale * other.read_bytes
        self.write_bytes += scale * other.write_bytes
        self.collective_bytes += scale * other.collective_bytes
        for k, v in other.by_kind.items():
            self.by_kind[k] = self.by_kind.get(k, 0.0) + scale * v
        for k, v in other.kernel_calls.items():
            self.kernel_calls[k] = self.kernel_calls.get(k, 0) + \
                int(scale * v)
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   other.peak_live_bytes)
        self.ops += int(scale * other.ops)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Counter(TorchDispatchMode):
    """Counts every aten operator dispatched while it is entered (inside a
    ``FakeTensorMode``); :meth:`result` applies the fusion rule.
    ``inputs``: the step's inputs (parameters, state, batch) alive before
    it starts, for the peak."""

    def __init__(self, inputs=()):
        super().__init__()
        self.flops = 0.0
        self.by_kind: Dict[str, float] = {}
        self.kernel_calls: Dict[str, int] = {}
        self.extra_bytes = 0.0             # indexed writes
        # per node: [kind, bytes, read by a non-fusible op, read]; kind
        # "in" (made before the trace, or written in place by an indexed
        # write: read, never counted written), "ew" (fusible), "op"
        self.nodes: List[List[Any]] = []
        # (producer node, bytes read)
        self.reads: List[Tuple[int, int]] = []
        self.node_of = WeakTensorKeyDictionary()
        self.ops = 0
        # peak: refcounts of live storages
        self._live = 0
        self.peak = 0
        self._refs: Dict[int, int] = {}
        self._size: Dict[int, int] = {}
        for t in tree_flatten(list(inputs))[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
                self.node_of[t] = self._new_node("in", _nbytes(t))

    # -- peak ---------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self._size[key] = st.nbytes()
            self._live += self._size[key]
            self.peak = max(self.peak, self._live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            self._live -= self._size.pop(key)
            del self._refs[key]

    # -- graph --------------------------------------------------------------
    def _new_node(self, kind: str, nbytes: int) -> int:
        self.nodes.append([kind, nbytes, False, False])
        return len(self.nodes) - 1

    def _node(self, t: torch.Tensor) -> int:
        n = self.node_of.get(t)
        if n is None:                      # made outside the trace
            n = self._new_node("in", _nbytes(t))
            self.node_of[t] = n
        return n

    def _read(self, t: torch.Tensor, consumer_fusible: bool) -> None:
        n = self._node(t)
        node = self.nodes[n]
        node[3] = True
        if not consumer_fusible:
            node[2] = True
        self.reads.append((n, min(_nbytes(t), node[1])))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload) or \
                func.namespace == "prim":
            return out
        self.ops += 1
        name = func._schema.name.split("::")[-1]
        qual = f"{func.namespace}::{name}"
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if func.is_view or name in _ALIASES:
            if ins:
                n = self._node(ins[0])
                for t in outs:
                    self.node_of[t] = n
            return out

        if name in _INDEXED_WRITES:
            upd = args[2] if len(args) > 2 and isinstance(
                args[2], torch.Tensor) else ins[-1]
            self.extra_bytes += _INDEXED_WRITES[name] * _nbytes(upd)
            for t in outs:
                self.node_of[t] = self._new_node("in", _nbytes(t))
            return out

        fusible = (torch.Tag.pointwise in func.tags or name in _LAYOUT) \
            and func.namespace == "aten"
        if func.namespace == "aten":
            if name in ("mm", "bmm", "addmm", "baddbmm", "mv", "dot"):
                self.flops += _matmul_flops(name, args)
            elif name in ("convolution", "_convolution"):
                self.flops += _conv_flops(args, outs[0])
        elif name == _COLLECTIVE:
            kind = args[1]
            self.by_kind[kind] = self.by_kind.get(kind, 0.0) + \
                _nbytes(args[0])
        elif qual in _FORMULAS:
            self.flops += float(_FORMULAS[qual](*args))
            self.kernel_calls[qual] = self.kernel_calls.get(qual, 0) + 1

        for t in ins:
            self._read(t, fusible)
        for t in outs:
            self.node_of[t] = self._new_node("ew" if fusible else "op",
                                             _nbytes(t))
        return out

    def result(self) -> Counts:
        """The counts of everything dispatched so far."""
        written = 0.0
        for kind, nbytes, by_op, read in self.nodes:
            if kind == "op" or (kind == "ew" and (by_op or not read)):
                written += nbytes
        read = 0.0
        for n, nbytes in self.reads:
            kind, _, by_op, _ = self.nodes[n]
            if kind != "ew" or by_op:
                read += nbytes
        coll = sum(self.by_kind.values())
        return Counts(flops=self.flops, read_bytes=read,
                      write_bytes=written + self.extra_bytes,
                      collective_bytes=coll, by_kind=dict(self.by_kind),
                      peak_live_bytes=float(self.peak),
                      kernel_calls=dict(self.kernel_calls), ops=self.ops)
