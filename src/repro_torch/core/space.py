"""Axes-first design-space API — port of :mod:`repro.core.space`.

* :func:`axis` / :class:`Axis` / :class:`AxisSet` — named design-space
  axes: ``catalog_param``, ``phy``, ``protocol_param``, ``protocol``,
  ``backlog``, ``trace``, ``workload_config``, ``mix``,
  ``read_fraction``, ``shoreline_mm`` and the Fig-13 pipelining axes
  ``k``, ``ucie_line_ui`` and ``device_line_ui``.
* :class:`DesignSpace` — lowers an axis combination onto the analytic
  catalog programs (:mod:`repro_torch.core.memsys`) and the flit
  simulators (:mod:`repro_torch.core.flitsim`) on one device;
  ``evaluate(..., stream=StreamConfig(...))`` streams one metric's
  frontier chunk by chunk instead (:mod:`repro_torch.core.streaming`).
* :class:`SpaceResult` / :class:`SpaceArray` — named-axis outputs (host
  numpy arrays) with ``sel()`` / ``argbest()`` / ``frontier()`` and the
  first-class ``feasible(constraints)`` mask.
* :func:`joint_frontier` — the joint (mix x backlog x shoreline)
  analytic-vs-simulated frontier; :meth:`DesignSpace.serving_frontier` —
  the per-(model, QPS) serving-trace frontier.

Winner reductions (``argbest``, ``joint_frontier``'s argmax) run in numpy
on the host, as in the reference, so label ties resolve the same way.
PyTorch runs eagerly, so the reference's shape-keyed compile cache has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

# =========================================================================
# Simulation execution config
# =========================================================================


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Execution config for the flit-simulation engines.

    ``mode="fixed"`` runs the full fixed horizon.  ``mode="adaptive"``
    runs the period-exact detectors and the fused chunked loop (one
    ``symmetric_run`` launch, ``chunk`` cycles a chunk), stopping as soon as
    every cell's reconstructed fixed-window estimate is stable to ``tol``
    (relative), or at the horizon.  ``max_cycles`` overrides the
    per-family horizon; ``chunk`` is shrunk per family to an exact
    divisor of the horizon.  ``trace_cycles`` is the cycles simulated per
    trace PHASE (``trace``-axis evaluations only, which always run the
    trace-scan cores); ``None`` uses the family's static horizon, which
    makes a single-phase trace bitwise equal to its static (mix, backlog)
    cell."""

    mode: str = "fixed"
    chunk: int = 128
    tol: float = 1e-3
    max_cycles: Optional[int] = None
    trace_cycles: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("fixed", "adaptive"):
            raise ValueError(f"SimConfig.mode must be 'fixed' or "
                             f"'adaptive', got {self.mode!r}")
        if int(self.chunk) < 8:
            raise ValueError(f"SimConfig.chunk must be >= 8, got "
                             f"{self.chunk}")
        if not self.tol > 0.0:
            raise ValueError(f"SimConfig.tol must be > 0, got {self.tol}")
        if self.max_cycles is not None and int(self.max_cycles) < 1:
            raise ValueError(f"SimConfig.max_cycles must be >= 1, got "
                             f"{self.max_cycles}")
        if self.trace_cycles is not None and int(self.trace_cycles) < 8:
            raise ValueError(f"SimConfig.trace_cycles must be >= 8, got "
                             f"{self.trace_cycles}")

    def horizon(self, default: int) -> int:
        """Resolved horizon for a family whose fixed length is
        ``default``."""
        return int(self.max_cycles) if self.max_cycles is not None \
            else int(default)

    def key(self) -> Tuple:
        """What sets the numbers: configs with equal keys simulate the
        same values (the reference keys its compile cache on it; this
        port runs eagerly and has none).  ``trace_cycles`` appends only
        when set, so the default keys stay the reference's."""
        trace = () if self.trace_cycles is None \
            else (int(self.trace_cycles),)
        if self.mode == "fixed":
            return ("fixed",) + trace
        return ("adaptive", int(self.chunk), float(self.tol),
                self.max_cycles) + trace


#: the default config: the full fixed horizon
FIXED_SIM = SimConfig()
#: convergence-adaptive early-exit simulation (explorer default)
ADAPTIVE_SIM = SimConfig(mode="adaptive")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Execution config of the streaming evaluation mode.

    ``DesignSpace.evaluate(..., stream=StreamConfig(...))`` switches from
    the materialized engines to :mod:`repro_torch.core.streaming`: the
    cell space is flattened along ``axis_order`` and cut into chunks of at
    most ``chunk_cells`` cells, and frontier / argbest / feasibility
    resolve as running reductions, so only the winner codes (one small
    integer per cell) come back.

    * ``chunk_cells`` — the per-rank, per-dispatch cell budget (the peak
      number of cells resident at once on a rank); clamped down when the
      space is smaller (to ``ceil(cells / devices)``).
    * ``axis_order`` — the chunked cell-axis order (default: canonical
      :data:`AXIS_ORDER`); a permutation of the space's cell axes that
      changes the dispatch order only, never the result.
    * ``devices`` — the ranks the stream is sharded over.  ``None`` or
      ``1``: this process streams the whole space on its own device (one
      process owns one card, so the reference's default of every local
      device is this process's card; inside a world each rank then
      streams alone).  ``N > 1``: the size of the initialized
      ``torch.distributed`` world, checked when the stream runs; rank
      ``r`` evaluates slot ``r`` of every window of ``N * chunk_cells``
      cells and every rank returns the same reduced result.  The
      reference's subset of leading devices has no counterpart: a rank
      outside it would have no result to return.
    * ``mode`` — argbest direction; ``None`` picks the metric's natural
      one (``min`` for ``pj_per_bit`` / ``power_w``, else ``max``).
    * ``constraints`` — optional
      :class:`repro_torch.core.selector.SelectionConstraints` folded into
      the analytic metrics' reduction (cells with no admissible system
      read ``"(none)"``, as in the materialized frontier).
    * ``prefetch`` — the bounded in-flight depth: the host marshals chunk
      ``t+1`` while up to ``prefetch`` earlier chunks run on the card, and
      retires them strictly FIFO, so every depth folds in the sequential
      loop's order (``prefetch=1``) and gives identical results.
    """

    chunk_cells: int = 4096
    axis_order: Optional[Tuple[str, ...]] = None
    devices: Optional[int] = None
    mode: Optional[str] = None
    constraints: Any = None
    prefetch: int = 2

    def __post_init__(self):
        if int(self.chunk_cells) < 1:
            raise ValueError(f"StreamConfig.chunk_cells must be >= 1, got "
                             f"{self.chunk_cells}")
        if int(self.prefetch) < 1:
            raise ValueError(f"StreamConfig.prefetch must be >= 1, got "
                             f"{self.prefetch}")
        if self.devices is not None and int(self.devices) < 1:
            raise ValueError(f"StreamConfig.devices must be >= 1, got "
                             f"{self.devices}")
        if self.mode not in (None, "max", "min"):
            raise ValueError(f"StreamConfig.mode must be None, 'max' or "
                             f"'min', got {self.mode!r}")
        if self.axis_order is not None:
            object.__setattr__(self, "axis_order",
                               tuple(str(a) for a in self.axis_order))

    def key(self) -> Tuple:
        """The reference's static key: which checks are active (the
        constraint STRUCTURE, last) and every other field."""
        cons = self.constraints
        cons_key = None if cons is None else (
            cons.packaging, cons.max_relative_bit_cost is not None,
            cons.max_backlog_knee is not None,
            cons.max_power_w is not None,
            cons.required_bandwidth_gbs is not None)
        return (int(self.chunk_cells), self.axis_order,
                None if self.devices is None else int(self.devices),
                self.mode, int(self.prefetch), cons_key)


# =========================================================================
# Axes
# =========================================================================

#: sentinel mix value: resolve to each workload config's own mix
OWN_MIX = "own"

#: canonical axis order — result dims follow it (the implicit ``system`` /
#: ``protocol`` dims lead; ``phy`` trails the stack dim)
AXIS_ORDER: Tuple[str, ...] = (
    "catalog_param", "phy", "protocol_param", "protocol", "backlog",
    "trace", "workload_config", "mix", "read_fraction", "shoreline_mm",
    "k", "ucie_line_ui", "device_line_ui")

def _mix_label(x: float, y: float) -> str:
    return f"{x:g}R{y:g}W"


def _as_mix_tuple(v) -> Tuple[float, float]:
    if hasattr(v, "x") and hasattr(v, "y"):         # TrafficMix
        x, y = float(v.x), float(v.y)
    else:
        x, y = v
        x, y = float(x), float(y)
    if x < 0 or y < 0 or x + y <= 0:
        raise ValueError(f"invalid traffic mix x={x} y={y}: need x, y >= 0 "
                         "and x + y > 0")
    return x, y


def _as_workload(v) -> Tuple[str, Any]:
    """Normalize a workload_config entry to (name, TrafficMix)."""
    from repro_torch.core.traffic import TrafficMix
    name, w = v
    if hasattr(w, "read_bytes_per_chip"):           # RooflineReport-like
        w = TrafficMix.from_bytes(w.read_bytes_per_chip,
                                  w.write_bytes_per_chip)
    elif not (hasattr(w, "x") and hasattr(w, "y")):
        x, y = _as_mix_tuple(w)
        w = TrafficMix(x, y)
    return str(name), w


def _as_perturbation(v) -> Tuple[str, Tuple[Tuple[str, float], ...]]:
    """Normalize a ``protocol_param`` / ``catalog_param`` entry to
    (label, sorted field->scale)."""
    if isinstance(v, Mapping):
        label, pert = None, v
    else:
        label, pert = v
    items = tuple(sorted((str(k), float(s)) for k, s in pert.items()))
    if label is None:
        # "+"-joined (not ","): labels land in CSV columns
        label = "+".join(f"{k}x{s:g}" for k, s in items) or "baseline"
    return str(label), items


@dataclasses.dataclass(frozen=True)
class Axis:
    """One named design-space axis: canonical values plus labels."""

    name: str
    values: Tuple[Any, ...]
    labels: Tuple[Any, ...]

    def __len__(self) -> int:
        return len(self.values)

    def index(self, label) -> int:
        """Position of ``label`` (accepts raw values for mix-like axes and
        ``UCIePhy`` objects for the ``phy`` axis)."""
        if label in self.labels:
            return self.labels.index(label)
        if self.name == "phy" and label in self.values:
            return self.values.index(label)
        if self.name == "mix" and label != OWN_MIX:
            return self.labels.index(_mix_label(*_as_mix_tuple(label)))
        if self.name in ("backlog", "shoreline_mm", "read_fraction",
                         "ucie_line_ui", "device_line_ui"):
            return self.labels.index(float(label))
        if self.name == "k":
            return self.labels.index(int(label))
        raise KeyError(f"label {label!r} not on axis {self.name!r}: "
                       f"{self.labels}")


def axis(name: str, values: Sequence[Any],
         labels: Optional[Sequence[Any]] = None) -> Axis:
    """Build a validated :class:`Axis`; values are normalized per kind.

    ``mix`` accepts ``(x, y)`` tuples, ``TrafficMix`` objects or the
    :data:`OWN_MIX` sentinel; ``workload_config`` a mapping or
    ``(name, mix-or-report)`` pairs; ``phy``
    :class:`repro_torch.core.ucie.UCIePhy` instances; ``protocol``
    flit-simulator keys; ``trace``
    :class:`repro_torch.traces.TrafficTrace` instances, padded to one
    phase count.  ``protocol_param`` accepts ``{field: scale}`` dicts or
    ``(label, dict)`` pairs — multiplicative perturbations of the
    flit-simulator parameter stacks; ``catalog_param`` is its analytic
    twin (PHY pJ/b and shoreline/areal density scales)."""
    vals = list(values.items()) if isinstance(values, Mapping) else \
        list(values)
    if not vals:
        raise ValueError(f"axis {name!r} needs at least one value")
    if name == "phy":
        from repro_torch.core.ucie import UCIePhy
        bad = [v for v in vals if not isinstance(v, UCIePhy)]
        if bad:
            raise ValueError(f"axis 'phy' values must be UCIePhy "
                             f"instances, got {bad}")
        norm = list(vals)
        labs = [p.name for p in vals]
        if len(set(labs)) != len(labs):
            raise ValueError(f"duplicate phy names on the axis: {labs}")
    elif name == "catalog_param":
        from repro_torch.core.ucie import PERTURBABLE_PHY_FIELDS
        norm = [_as_perturbation(v) for v in vals]
        for _, items in norm:
            unknown = sorted(k for k, _ in items
                             if k not in PERTURBABLE_PHY_FIELDS)
            if unknown:
                raise ValueError(
                    f"unknown catalog perturbation fields {unknown}; "
                    f"choose from {PERTURBABLE_PHY_FIELDS}")
        labs = [lab for lab, _ in norm]
    elif name == "mix":
        norm = [OWN_MIX if (isinstance(v, str) and v == OWN_MIX)
                else _as_mix_tuple(v) for v in vals]
        labs = [OWN_MIX if v == OWN_MIX else _mix_label(*v) for v in norm]
    elif name == "read_fraction":
        norm = [float(v) for v in vals]
        for r in norm:
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"read_fraction {r} outside [0, 1]")
        labs = list(norm)
    elif name == "workload_config":
        norm = [_as_workload(v) for v in vals]
        labs = [n for n, _ in norm]
    elif name == "protocol":
        norm = [str(v) for v in vals]
        labs = list(norm)
    elif name == "trace":
        from repro_torch.traces.trace import TrafficTrace, pad_traces
        bad = [v for v in vals if not isinstance(v, TrafficTrace)]
        if bad:
            raise ValueError(f"axis 'trace' values must be TrafficTrace "
                             f"instances, got {bad}")
        # padded to one shared phase count, so the whole axis runs as ONE
        # [T, N] grid (one trace-kernel launch per engine family)
        norm = list(pad_traces(vals))
        labs = [t.name for t in norm]
        if len(set(labs)) != len(labs):
            raise ValueError(f"duplicate trace names on the axis: {labs}")
    elif name == "protocol_param":
        norm = [_as_perturbation(v) for v in vals]
        labs = [lab for lab, _ in norm]
    elif name == "k":
        norm = [int(v) for v in vals]
        labs = list(norm)
    elif name in ("backlog", "shoreline_mm", "ucie_line_ui",
                  "device_line_ui"):
        norm = [float(v) for v in vals]
        labs = list(norm)
    else:
        raise ValueError(f"unknown axis name {name!r}; choose from "
                         f"{AXIS_ORDER}")
    if labels is not None:
        if len(labels) != len(norm):
            raise ValueError(f"axis {name!r}: {len(labels)} labels for "
                             f"{len(norm)} values")
        labs = list(labels)
    return Axis(name=name, values=tuple(norm), labels=tuple(labs))


class AxisSet:
    """Ordered, validated collection of axes (canonical order, unique
    names, ``mix``/``read_fraction`` mutually exclusive, ``trace``
    exclusive with the static traffic axes)."""

    def __init__(self, *axes: Union[Axis, Sequence[Axis]]):
        flat: List[Axis] = []
        for a in axes:
            if isinstance(a, Axis):
                flat.append(a)
            else:
                flat.extend(a)
        names = [a.name for a in flat]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in {names}")
        if "mix" in names and "read_fraction" in names:
            raise ValueError("axes 'mix' and 'read_fraction' are mutually "
                             "exclusive — both name the traffic-mix axis")
        if "trace" in names:
            clash = sorted(set(names) & {"backlog", "mix", "read_fraction",
                                         "workload_config"})
            if clash:
                raise ValueError(
                    f"axis 'trace' is exclusive with {clash}: a trace's "
                    "phases already carry the mix and backlog trajectory")
        self._axes: Dict[str, Axis] = {
            name: next(a for a in flat if a.name == name)
            for name in sorted(names, key=AXIS_ORDER.index)}

    def __contains__(self, name: str) -> bool:
        return name in self._axes

    def __getitem__(self, name: str) -> Axis:
        return self._axes[name]

    def __iter__(self):
        return iter(self._axes.values())

    def __len__(self) -> int:
        return len(self._axes)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._axes)

    def get(self, name: str) -> Optional[Axis]:
        return self._axes.get(name)

    def mix_axis(self) -> Optional[Axis]:
        return self._axes.get("mix") or self._axes.get("read_fraction")


# =========================================================================
# Named-axis results
# =========================================================================


def _union_layout(a: "SpaceArray", b: "SpaceArray"
                  ) -> Tuple[Tuple[str, ...], Tuple[Tuple[Any, ...], ...]]:
    """Union of two arrays' named dims (a's order first), coords
    reconciled — mismatched labels on a shared dim are an error."""
    dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    coords = []
    for d in dims:
        ca = a.coord(d) if d in a.dims else None
        cb = b.coord(d) if d in b.dims else None
        if ca is not None and cb is not None and ca != cb:
            raise ValueError(f"dim {d!r} has mismatched coords: "
                             f"{ca} vs {cb}")
        coords.append(ca if ca is not None else cb)
    return tuple(dims), tuple(coords)


def _expand_to(dims: Tuple[str, ...], coords, arr: "SpaceArray"
               ) -> np.ndarray:
    """View of ``arr.values`` broadcastable over the ``dims`` layout."""
    unknown = [d for d in arr.dims if d not in dims]
    if unknown:
        raise ValueError(f"dims {unknown} of the operand are not in the "
                         f"target layout {dims}")
    perm = sorted(range(len(arr.dims)),
                  key=lambda i: dims.index(arr.dims[i]))
    v = np.transpose(arr.values, perm)
    shape = tuple(len(coords[j]) if dims[j] in arr.dims else 1
                  for j in range(len(dims)))
    return v.reshape(shape)


def _as_mask(where, like: "SpaceArray") -> "SpaceArray":
    """Normalize a ``where=`` operand to a boolean :class:`SpaceArray`."""
    if isinstance(where, SpaceArray):
        return SpaceArray(where.dims, where.coords,
                          np.asarray(where.values, bool))
    return SpaceArray(like.dims, like.coords,
                      np.broadcast_to(np.asarray(where, bool), like.shape))


@dataclasses.dataclass(frozen=True)
class SpaceArray:
    """A metric array (host numpy) with named dims and label coords."""

    dims: Tuple[str, ...]
    coords: Tuple[Tuple[Any, ...], ...]
    values: np.ndarray

    def __post_init__(self):
        if len(self.dims) != len(self.coords) or \
                tuple(len(c) for c in self.coords) != self.values.shape:
            raise ValueError(
                f"dims {self.dims} / coords "
                f"{tuple(len(c) for c in self.coords)} do not match value "
                f"shape {self.values.shape}")

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.values.shape

    def coord(self, dim: str) -> Tuple[Any, ...]:
        return self.coords[self.dims.index(dim)]

    def _label_index(self, dim: str, label) -> int:
        labels = self.coord(dim)
        if label in labels:
            return labels.index(label)
        if getattr(label, "name", None) in labels:
            return labels.index(label.name)
        if dim == "mix" and label != OWN_MIX:
            try:
                return labels.index(_mix_label(*_as_mix_tuple(label)))
            except (TypeError, ValueError):
                pass
        try:
            return labels.index(float(label))
        except (TypeError, ValueError):
            raise KeyError(f"label {label!r} not on dim {dim!r}: {labels}")

    def isel(self, **indexers: int) -> "SpaceArray":
        """Integer selection; each selected dim is dropped."""
        out = self.values
        dims, coords = list(self.dims), list(self.coords)
        for dim in sorted(indexers, key=self.dims.index, reverse=True):
            ax = dims.index(dim)
            out = np.take(out, indexers[dim], axis=ax)
            del dims[ax], coords[ax]
        return SpaceArray(tuple(dims), tuple(coords), np.asarray(out))

    def sel(self, *, where=None, **labels) -> "SpaceArray":
        """Label-based selection; each selected dim is dropped.  ``where``
        masks the selected values (cells outside become NaN)."""
        out = self.isel(**{d: self._label_index(d, v)
                           for d, v in labels.items()})
        if where is None:
            return out
        w = _as_mask(where, self)
        w = w.isel(**{d: w._label_index(d, v) for d, v in labels.items()
                      if d in w.dims})
        dims, coords = _union_layout(out, w)
        if dims != out.dims:
            raise ValueError(
                f"where-mask dims {w.dims} are not a subset of the "
                f"selected array dims {out.dims}")
        wv = np.broadcast_to(_expand_to(dims, coords, w), out.shape)
        return SpaceArray(out.dims, out.coords,
                          np.where(wv, out.values, np.nan))

    def argbest(self, dim: str = "system", mode: str = "max",
                where=None) -> "SpaceArray":
        """Best label along ``dim`` per remaining point; masked-out
        entries never win and points where nothing is admissible read
        ``"(none)"``."""
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        if where is None:
            ax = self.dims.index(dim)
            idx = (np.argmax if mode == "max" else np.argmin)(self.values,
                                                              axis=ax)
            labels = np.asarray(self.coord(dim), dtype=object)[idx]
            dims = self.dims[:ax] + self.dims[ax + 1:]
            coords = self.coords[:ax] + self.coords[ax + 1:]
            return SpaceArray(dims, coords, labels)
        w = _as_mask(where, self)
        dims, coords = _union_layout(self, w)
        if dim not in dims:
            raise KeyError(f"dim {dim!r} not in {dims}")
        shape = tuple(len(c) for c in coords)
        vals = np.broadcast_to(_expand_to(dims, coords, self), shape)
        wv = np.broadcast_to(_expand_to(dims, coords, w), shape)
        fill = -np.inf if mode == "max" else np.inf
        masked = np.where(wv, np.asarray(vals, np.float64), fill)
        ax = dims.index(dim)
        idx = (np.argmax if mode == "max" else np.argmin)(masked, axis=ax)
        labels = np.asarray(coords[ax], dtype=object)[idx]
        labels = np.where(wv.any(axis=ax), labels, "(none)")
        return SpaceArray(dims[:ax] + dims[ax + 1:],
                          coords[:ax] + coords[ax + 1:],
                          np.asarray(labels, dtype=object))

    def best(self, dim: str = "system", mode: str = "max") -> "SpaceArray":
        """Best value along ``dim`` per remaining point."""
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        ax = self.dims.index(dim)
        red = (np.max if mode == "max" else np.min)(self.values, axis=ax)
        return SpaceArray(self.dims[:ax] + self.dims[ax + 1:],
                          self.coords[:ax] + self.coords[ax + 1:],
                          np.asarray(red))


@dataclasses.dataclass(frozen=True)
class SpaceResult:
    """Named-axis evaluation of a :class:`DesignSpace`: ``arrays`` maps
    metric name -> :class:`SpaceArray`; ``sim`` is the
    :class:`SimConfig` the simulated metrics ran under and ``device`` the
    device the engines ran on."""

    axes: AxisSet
    arrays: Dict[str, SpaceArray]
    sim: Optional[SimConfig] = None
    device: Any = None

    def __getitem__(self, metric: str) -> SpaceArray:
        return self.arrays[metric]

    def __contains__(self, metric: str) -> bool:
        return metric in self.arrays

    @property
    def metrics(self) -> Tuple[str, ...]:
        return tuple(self.arrays)

    def argbest(self, metric: str, dim: str = "system",
                mode: str = "max", where=None) -> SpaceArray:
        return self.arrays[metric].argbest(dim, mode, where=where)

    def frontier(self, metric: str, dim: str = "system",
                 mode: str = "max", where=None) -> SpaceArray:
        """Alias of :meth:`argbest` — the winning label per grid point."""
        return self.argbest(metric, dim, mode, where=where)

    def feasible(self, constraints=None, *,
                 catalog: Optional[Dict[str, Any]] = None,
                 sim: Optional[SimConfig] = None) -> SpaceArray:
        """Boolean :class:`SpaceArray` marking which (system, point)
        cells satisfy ``constraints``
        (:class:`repro_torch.core.selector.SelectionConstraints`):
        packaging / bit cost per system (per phy with a ``phy`` axis),
        the backlog-knee budget at the most specific mix available, and
        the point-dependent power / bandwidth caps."""
        from repro_torch.core import memsys
        from repro_torch.core import selector as selector_mod
        if constraints is None:
            constraints = selector_mod.SelectionConstraints()
        base = None
        for m in ANALYTIC_METRICS:
            if m in self.arrays:
                base = self.arrays[m]
                break
        if base is None:
            raise ValueError(
                "feasible() needs at least one analytic catalog metric "
                f"({ANALYTIC_METRICS}) on the result; evaluate them first")
        dims, coords = base.dims, base.coords
        keys = base.coord("system")
        mask = np.ones(tuple(len(c) for c in coords), dtype=bool)

        def apply(sub_dims, sub_vals):
            sub = SpaceArray(tuple(sub_dims),
                             tuple(coords[dims.index(d)] for d in sub_dims),
                             np.asarray(sub_vals))
            return np.broadcast_to(_expand_to(dims, coords, sub),
                                   mask.shape)

        phy_ax = self.axes.get("phy")
        if phy_ax is not None and "phy" in dims:
            items = dict(memsys.approach_catalog_items())
            missing = [k for k in keys if k not in items]
            if missing:
                raise ValueError(f"unknown approach keys {missing} on the "
                                 "system axis of a phy-stacked result")
            items = tuple((k, items[k]) for k in keys)
            if constraints.packaging:
                mask &= apply(("phy",), [
                    p.packaging.value == constraints.packaging
                    for p in phy_ax.values])
            if constraints.max_relative_bit_cost is not None:
                mask &= apply(("system",), [
                    ms.relative_bit_cost <= constraints.max_relative_bit_cost
                    for _, ms in items])
        else:
            items = (memsys.default_catalog_items() if catalog is None
                     else tuple(catalog.items()))
            if tuple(k for k, _ in items) != tuple(keys):
                raise ValueError(
                    "catalog keys do not match the result's system axis; "
                    "pass feasible(catalog=...) matching the evaluated "
                    "DesignSpace(catalog=...)")
            static = selector_mod.system_mask(
                items, dataclasses.replace(constraints,
                                           max_backlog_knee=None))
            mask &= apply(("system",), static)

        if constraints.max_backlog_knee is not None:
            mask &= self._knee_mask(keys, constraints, apply,
                                    sim if sim is not None else self.sim)

        if constraints.max_power_w is not None:
            pw = self.arrays.get("power_w")
            if pw is None:
                raise ValueError("a max_power_w constraint needs the "
                                 "'power_w' metric on the result")
            mask &= apply(pw.dims, pw.values <= constraints.max_power_w)
        if constraints.required_bandwidth_gbs is not None:
            bw = self.arrays.get("bandwidth_gbs")
            if bw is None:
                raise ValueError("a required_bandwidth_gbs constraint "
                                 "needs the 'bandwidth_gbs' metric on the "
                                 "result")
            mask &= apply(bw.dims,
                          bw.values >= constraints.required_bandwidth_gbs)
        return SpaceArray(dims, coords, mask)

    def _knee_mask(self, keys, constraints, apply,
                   sim: Optional[SimConfig] = None) -> np.ndarray:
        """Backlog-knee admissibility at the most specific mix available:
        per workload config, else per mix point, else the envelope."""
        from repro_torch.core import flitsim
        from repro_torch.core import selector as selector_mod
        budget = constraints.max_backlog_knee
        simkeys = [selector_mod.sim_key_for(k) for k in keys]
        cfg = self.axes.get("workload_config")
        mix_ax = self.axes.mix_axis()
        if cfg is not None:
            mixes = [(w.x, w.y) for _, w in cfg.values]
            per_dims = ("system", "workload_config")
        elif mix_ax is not None and OWN_MIX not in mix_ax.values:
            if mix_ax.name == "read_fraction":
                mixes = [(100.0 * r, 100.0 - 100.0 * r)
                         for r in mix_ax.values]
            else:
                mixes = list(mix_ax.values)
            per_dims = ("system", mix_ax.name)
        else:
            knees = selector_mod.default_knees(self.device)
            sub = [sk is None or knees[sk] <= budget for sk in simkeys]
            return apply(("system",), sub)
        per = flitsim.backlog_knees(mixes=mixes, per_mix=True, sim=sim,
                                    device=self.device)
        sub = np.ones((len(keys), len(mixes)), dtype=bool)
        for i, sk in enumerate(simkeys):
            if sk is not None:
                sub[i] = per[sk] <= budget
        return apply(per_dims, sub)


def regimes(labels: Sequence[Any], fracs: Sequence[float]
            ) -> List[Tuple[float, float, Any]]:
    """Contiguous (lo, hi, label) regimes along a fraction axis;
    boundaries fall at the midpoint between the last sample of one winner
    and the first of the next, so the regimes tile [0, 1] exactly."""
    labels = list(labels)
    fracs = [float(f) for f in fracs]
    out: List[Tuple[float, float, Any]] = []
    start, lo = 0, 0.0
    for j in range(1, len(labels) + 1):
        if j == len(labels) or labels[j] != labels[start]:
            hi = 1.0 if j == len(labels) else (fracs[j - 1] + fracs[j]) / 2.0
            out.append((lo, hi, labels[start]))
            start, lo = j, hi
    return out


# =========================================================================
# DesignSpace
# =========================================================================

#: analytic catalog metrics (dims: system [x phy] [x configs] [x mix]
#: [x shoreline])
ANALYTIC_METRICS: Tuple[str, ...] = (
    "bandwidth_gbs", "pj_per_bit", "power_w", "gbs_per_watt")
#: per-system static columns (dims: system)
SYSTEM_METRICS: Tuple[str, ...] = ("latency_ns", "relative_bit_cost")
#: flit-simulated metrics (dims: protocol [x backlog] ...)
SIM_METRICS: Tuple[str, ...] = ("sim_efficiency", "analytic_efficiency")
#: simulated efficiency x the PHY's raw link bandwidth (needs a phy axis)
SIM_PHY_METRICS: Tuple[str, ...] = ("sim_bandwidth_gbs",)
#: approach-density metrics on a PHY (dims: approach [x phy] [x mix])
APPROACH_METRICS: Tuple[str, ...] = (
    "linear_density_gbs_mm", "areal_density_gbs_mm2", "approach_pj_per_bit")
#: Fig-13 pipelining metric (dims: k [x ucie_line_ui] [x device_line_ui])
PIPELINE_METRICS: Tuple[str, ...] = ("utilization",)
#: trace-scan metrics (need a ``trace`` axis): duration-weighted
#: efficiency over the phase sequence (dims: protocol x trace) and the raw
#: per-phase grid (... x phase) with state carried across phase boundaries
TRACE_METRICS: Tuple[str, ...] = ("trace_efficiency",
                                  "trace_phase_efficiency")
#: duration-weighted trace efficiency x the PHY's raw link bandwidth ->
#: delivered GB/s over the serving trace (needs a phy)
TRACE_PHY_METRICS: Tuple[str, ...] = ("trace_bandwidth_gbs",)


class DesignSpace:
    """A declarative, axes-first view of the paper's design space.

    ``DesignSpace(axes).evaluate()`` lowers the requested axis combination
    onto the analytic catalog programs and the flit simulators on
    ``device`` (default ``"cuda"``) and returns a :class:`SpaceResult`.
    """

    def __init__(self, axes: Union[AxisSet, Sequence[Axis]], *,
                 catalog: Optional[Dict[str, Any]] = None,
                 phy: Any = None,
                 default_shoreline_mm: float = 8.0,
                 default_backlog: float = 64.0,
                 n_flits: int = 2048, n_accesses: int = 4096,
                 n_lines: int = 512,
                 sim: Optional[SimConfig] = None,
                 device=None):
        from repro_torch import device as device_mod
        self.axes = axes if isinstance(axes, AxisSet) else AxisSet(axes)
        self.catalog = catalog
        self.phy = phy
        self.default_shoreline_mm = float(default_shoreline_mm)
        self.default_backlog = float(default_backlog)
        self.n_flits = int(n_flits)
        self.n_accesses = int(n_accesses)
        self.n_lines = int(n_lines)
        self.sim = sim if sim is not None else FIXED_SIM
        self.device = device_mod.resolve(device)
        mix_ax = self.axes.mix_axis()
        if mix_ax is not None and mix_ax.name == "mix":
            if OWN_MIX in mix_ax.values and \
                    "workload_config" not in self.axes:
                raise ValueError("mix axis uses OWN_MIX but no "
                                 "workload_config axis provides the mixes")
        if "phy" in self.axes:
            if self.phy is not None:
                raise ValueError("pass the PHY either as "
                                 "DesignSpace(phy=...) or as a 'phy' "
                                 "axis, not both")
            if self.catalog is not None:
                raise ValueError(
                    "a 'phy' axis stacks the per-approach templates "
                    "(memsys.approach_catalog_items) and is incompatible "
                    "with a custom catalog= of PHY-baked systems")

    # -- lowering helpers ---------------------------------------------------

    def _mix_arrays(self) -> Tuple[np.ndarray, np.ndarray, Tuple[str, ...]]:
        """x / y f32 arrays over the present (workload_config, mix) axes,
        shaped ``[C, M]`` / ``[C]`` / ``[M]`` (or ``[1]``), plus the dim
        names covered."""
        cfg = self.axes.get("workload_config")
        mix_ax = self.axes.mix_axis()
        if mix_ax is not None and mix_ax.name == "read_fraction":
            mixes = [(100.0 * r, 100.0 - 100.0 * r)
                     for r in mix_ax.values]
        elif mix_ax is not None:
            mixes = list(mix_ax.values)
        else:
            mixes = None
        if cfg is not None and mixes is not None:
            x = np.empty((len(cfg), len(mixes)), np.float32)
            y = np.empty_like(x)
            for c, (_, own) in enumerate(cfg.values):
                for m, mx in enumerate(mixes):
                    xx, yy = (own.x, own.y) if mx == OWN_MIX else mx
                    x[c, m], y[c, m] = xx, yy
            return x, y, ("workload_config", mix_ax.name)
        if cfg is not None:
            x = np.asarray([w.x for _, w in cfg.values], np.float32)
            y = np.asarray([w.y for _, w in cfg.values], np.float32)
            return x, y, ("workload_config",)
        if mixes is not None:
            if OWN_MIX in mixes:
                raise ValueError("OWN_MIX requires a workload_config axis")
            x = np.asarray([m[0] for m in mixes], np.float32)
            y = np.asarray([m[1] for m in mixes], np.float32)
            return x, y, (mix_ax.name,)
        return (np.asarray([100.0], np.float32),
                np.asarray([0.0], np.float32), ())

    def _default_metrics(self) -> Tuple[str, ...]:
        out: List[str] = []
        names = self.axes.names
        if self.axes.mix_axis() is not None or "workload_config" in names:
            if self.phy is not None:
                out += list(APPROACH_METRICS)
            elif "phy" in names:
                out += (list(ANALYTIC_METRICS) + list(SYSTEM_METRICS)
                        + list(APPROACH_METRICS))
            else:
                out += list(ANALYTIC_METRICS) + list(SYSTEM_METRICS)
            if ("backlog" in names or "protocol" in names
                    or "protocol_param" in names):
                out += list(SIM_METRICS)
                if "phy" in names or self.phy is not None:
                    out += list(SIM_PHY_METRICS)
        if "trace" in names:
            out += list(TRACE_METRICS)
            if "phy" in names or self.phy is not None:
                out += list(TRACE_PHY_METRICS)
        if "k" in names:
            out += list(PIPELINE_METRICS)
        if not out:
            raise ValueError(
                f"no metric is evaluable over axes {names}; add a traffic "
                "axis (mix/read_fraction/workload_config), a trace axis, "
                "or a pipelining axis (k)")
        return tuple(out)

    def _tensor(self, a) -> "Any":
        import torch
        return torch.as_tensor(np.array(a, np.float32),
                               device=self.device)

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, metrics: Optional[Sequence[str]] = None, *,
                 sim: Optional[SimConfig] = None,
                 stream: Optional[StreamConfig] = None):
        """Resolve the requested metrics over the full joint axis space;
        ``sim`` overrides the space's :class:`SimConfig` for this call.

        ``stream`` (a :class:`StreamConfig`) switches to the streaming
        engine for 10^6-10^8-cell spaces: ONE metric's frontier reduced
        chunk by chunk, returned as a
        :class:`repro_torch.core.streaming.StreamResult` whose winner
        labels equal the materialized ``argbest`` instead of a
        :class:`SpaceResult`."""
        if stream is not None:
            from repro_torch.core import streaming
            return streaming.stream_evaluate(
                self, metrics, sim if sim is not None else self.sim,
                stream)
        cfg = sim if sim is not None else self.sim
        wanted = tuple(metrics) if metrics is not None else \
            self._default_metrics()
        known = (ANALYTIC_METRICS + SYSTEM_METRICS + SIM_METRICS
                 + SIM_PHY_METRICS + APPROACH_METRICS + PIPELINE_METRICS
                 + TRACE_METRICS + TRACE_PHY_METRICS)
        unknown = [m for m in wanted if m not in known]
        if unknown:
            raise ValueError(f"unknown metrics {unknown}; choose from "
                             f"{known}")
        arrays: Dict[str, SpaceArray] = {}
        if any(m in wanted for m in ANALYTIC_METRICS + SYSTEM_METRICS):
            arrays.update(self._eval_catalog(wanted))
        if any(m in wanted for m in APPROACH_METRICS):
            arrays.update(self._eval_approaches(wanted))
        if any(m in wanted for m in SIM_METRICS + SIM_PHY_METRICS):
            arrays.update(self._eval_sim(wanted, cfg))
        if any(m in wanted for m in TRACE_METRICS + TRACE_PHY_METRICS):
            arrays.update(self._eval_trace(wanted, cfg))
        if any(m in wanted for m in PIPELINE_METRICS):
            arrays.update(self._eval_pipelining(wanted, cfg))
        return SpaceResult(axes=self.axes, arrays=arrays, sim=cfg,
                           device=self.device)

    def _perturbations(self) -> List[Dict[str, float]]:
        cp_ax = self.axes.get("catalog_param")
        return ([dict(p) for _, p in cp_ax.values]
                if cp_ax is not None else [{}])

    def _eval_catalog(self, wanted) -> Dict[str, SpaceArray]:
        from repro_torch.core import memsys
        phy_ax = self.axes.get("phy")
        cp_ax = self.axes.get("catalog_param")
        perts = self._perturbations()
        x, y, mix_dims = self._mix_arrays()
        sl_ax = self.axes.get("shoreline_mm")
        if sl_ax is not None:
            sl = np.asarray(sl_ax.values, np.float32)
            xb, yb = x[..., None], y[..., None]
        else:
            sl = np.float32(self.default_shoreline_mm)
            xb, yb = x, y
        xt, yt, slt = self._tensor(xb), self._tensor(yb), self._tensor(sl)
        if phy_ax is not None:
            # PHY-stacked programs: (catalog_param x phy) folded into the
            # phys stack, approaches as the system dim
            items = memsys.approach_catalog_items()
            phys = [phy.perturbed(p) for p in perts for phy in phy_ax.values]
            grids = memsys.run_catalog_phys_program(items, phys, xt, yt, slt)
            lead = (len(perts), len(phy_ax), len(items))
            # [Q*F, S, ...] -> [Q, S, F, ...] (system before phy)
            grids = [np.moveaxis(g.cpu().numpy().reshape(lead + g.shape[2:]),
                                 2, 1) for g in grids]
            extra_dims: Tuple[str, ...] = ("phy",)
            extra_coords: Tuple[Tuple[Any, ...], ...] = (phy_ax.labels,)
        else:
            items = (memsys.default_catalog_items() if self.catalog is None
                     else tuple(self.catalog.items()))
            flat = (memsys.perturbed_catalog_items(items, perts)
                    if cp_ax is not None else items)
            lead = (len(perts), len(items))
            grids = [g.cpu().numpy().reshape(lead + g.shape[1:]) for g in
                     memsys.run_catalog_program(flat, xt, yt, slt)]
            extra_dims, extra_coords = (), ()
        bw, pjb, pw, gpw = grids
        keys = tuple(k for k, _ in items)
        dims = ("catalog_param", "system") + extra_dims + mix_dims + (
            ("shoreline_mm",) if sl_ax is not None else ())
        coords = ((cp_ax.labels if cp_ax is not None else ("baseline",)),
                  keys) + extra_coords \
            + tuple(self.axes[d].labels for d in mix_dims) \
            + ((sl_ax.labels,) if sl_ax is not None else ())
        if cp_ax is None:
            dims, coords = dims[1:], coords[1:]
        vals = {"bandwidth_gbs": bw, "pj_per_bit": pjb, "power_w": pw,
                "gbs_per_watt": gpw}
        out: Dict[str, SpaceArray] = {}
        for name in ANALYTIC_METRICS:
            if name in wanted:
                v = vals[name] if cp_ax is not None else vals[name][0]
                # squeeze the placeholder mix point when no traffic axis
                v = v.reshape(tuple(len(c) for c in coords))
                out[name] = SpaceArray(dims, coords, v)
        if "latency_ns" in wanted:
            out["latency_ns"] = SpaceArray(
                ("system",), (keys,),
                np.asarray([ms.latency_ns for _, ms in items], np.float32))
        if "relative_bit_cost" in wanted:
            out["relative_bit_cost"] = SpaceArray(
                ("system",), (keys,),
                np.asarray([ms.relative_bit_cost for _, ms in items],
                           np.float32))
        return out

    def _eval_approaches(self, wanted) -> Dict[str, SpaceArray]:
        from repro_torch.core import memsys
        from repro_torch.core.protocols import ALL_APPROACHES
        phy_ax = self.axes.get("phy")
        cp_ax = self.axes.get("catalog_param")
        perts = self._perturbations()
        if self.phy is None and phy_ax is None:
            raise ValueError("approach metrics need DesignSpace(phy=...) "
                             "or a 'phy' axis")
        base_phys = list(phy_ax.values) if phy_ax is not None \
            else [self.phy]
        phys = [p.perturbed(q) for q in perts for p in base_phys]
        x, y, mix_dims = self._mix_arrays()
        lin, areal, pjb = memsys.run_approach_phys_program(
            phys, self._tensor(x), self._tensor(y))
        keys = tuple(ALL_APPROACHES)
        lead = (len(perts), len(base_phys), len(keys))
        dims = ("catalog_param", "approach") + (
            ("phy",) if phy_ax is not None else ()) + mix_dims
        coords = ((cp_ax.labels if cp_ax is not None else ("baseline",)),
                  keys) + ((phy_ax.labels,) if phy_ax is not None
                           else ()) \
            + tuple(self.axes[d].labels for d in mix_dims)
        if cp_ax is None:
            dims, coords = dims[1:], coords[1:]
        vals = {"linear_density_gbs_mm": lin,
                "areal_density_gbs_mm2": areal,
                "approach_pj_per_bit": pjb}
        out: Dict[str, SpaceArray] = {}
        for name in APPROACH_METRICS:
            if name not in wanted:
                continue
            # [Q*F, A, ...] -> [Q, A, F, ...] (approach before phy)
            v = vals[name].cpu().numpy()
            v = np.moveaxis(v.reshape(lead + v.shape[2:]), 2, 1)
            if cp_ax is None:
                v = v[0]
            if phy_ax is None:          # drop the singleton phy dim
                v = np.take(v, 0, axis=2 if cp_ax is not None else 1)
            out[name] = SpaceArray(
                dims, coords, v.reshape(tuple(len(c) for c in coords)))
        return out

    def _sim_protocols(self) -> Tuple[str, ...]:
        from repro_torch.core import flitsim
        ax = self.axes.get("protocol")
        keys = tuple(ax.values) if ax is not None else \
            flitsim.SIMULATED_PROTOCOLS
        unknown = [k for k in keys if k not in flitsim.SIMULATORS]
        if unknown:
            raise ValueError(f"unknown protocol keys {unknown}; choose "
                             f"from {sorted(flitsim.SIMULATORS)}")
        return keys

    def _phys(self, metric: str) -> List[Any]:
        """The PHYs a PHY-absolute metric threads: the ``phy`` axis's, or
        ``DesignSpace(phy=...)``."""
        phy_ax = self.axes.get("phy")
        if phy_ax is not None:
            return list(phy_ax.values)
        if self.phy is not None:
            return [self.phy]
        raise ValueError(
            f"the {metric!r} metric threads the PHY's raw link bandwidth "
            "into the simulated efficiency — add a 'phy' axis or pass "
            "DesignSpace(phy=...)")

    def _protocol_perturbations(self) -> List[Dict[str, float]]:
        pert_ax = self.axes.get("protocol_param")
        return ([dict(p) for _, p in pert_ax.values]
                if pert_ax is not None else [{}])

    def _phy_dim(self, dims, coords, v, metric: str):
        """``v`` over ``dims`` times each PHY's raw link bandwidth: a
        ``phy`` dim after ``protocol`` (none for ``DesignSpace(phy=...)``)."""
        phys = self._phys(metric)
        raw = np.asarray([p.raw_bandwidth_gbs for p in phys], np.float32)
        ax_p = dims.index("protocol")
        v = (np.expand_dims(np.asarray(v), ax_p + 1)
             * raw.reshape((len(raw),) + (1,) * (np.ndim(v) - ax_p - 1)))
        bdims = tuple(dims[:ax_p + 1]) + ("phy",) + tuple(dims[ax_p + 1:])
        bcoords = tuple(coords[:ax_p + 1]) \
            + (tuple(p.name for p in phys),) + tuple(coords[ax_p + 1:])
        if "phy" not in self.axes:      # DesignSpace(phy=...): no phy dim
            v = np.take(v, 0, axis=ax_p + 1)
            bdims = bdims[:ax_p + 1] + bdims[ax_p + 2:]
            bcoords = bcoords[:ax_p + 1] + bcoords[ax_p + 2:]
        return SpaceArray(bdims, bcoords, v)

    def _eval_sim(self, wanted, sim: SimConfig) -> Dict[str, SpaceArray]:
        from repro_torch.core import flitsim
        keys = self._sim_protocols()
        x, y, mix_dims = self._mix_arrays()
        mix_shape = x.shape
        xf = x.reshape(-1)
        yf = y.reshape(-1)
        if np.any(xf < 0) or np.any(yf < 0) or np.any(xf + yf <= 0):
            raise ValueError("invalid traffic mix in the lowered grid")
        bl_ax = self.axes.get("backlog")
        backlogs = np.asarray(bl_ax.values if bl_ax is not None
                              else [self.default_backlog], np.float32)
        pert_ax = self.axes.get("protocol_param")
        eff = flitsim.simulate_grid(
            keys, xf, yf, backlogs,
            perturbations=self._protocol_perturbations(),
            n_flits=self.n_flits, n_accesses=self.n_accesses, sim=sim,
            device=self.device).cpu().numpy()
        # eff: [Q, P, B, Mf] -> named dims, dropping absent axes
        eff = eff.reshape(eff.shape[:3] + mix_shape)
        dims: List[str] = ["protocol_param", "protocol", "backlog"]
        coords: List[Tuple] = [
            pert_ax.labels if pert_ax is not None else ("baseline",),
            keys,
            bl_ax.labels if bl_ax is not None else (self.default_backlog,)]
        dims += list(mix_dims)
        coords += [self.axes[d].labels for d in mix_dims]
        if pert_ax is None:
            eff = eff[0]
            dims, coords = dims[1:], coords[1:]
        if bl_ax is None:
            ax_b = dims.index("backlog")
            eff = np.take(eff, 0, axis=ax_b)
            del dims[ax_b], coords[ax_b]
        if not mix_dims:                     # placeholder 100R0W point
            eff = eff[..., 0]
        out: Dict[str, SpaceArray] = {}
        if "sim_efficiency" in wanted:
            out["sim_efficiency"] = SpaceArray(
                tuple(dims), tuple(coords), np.asarray(eff))
        if "sim_bandwidth_gbs" in wanted:
            out["sim_bandwidth_gbs"] = self._phy_dim(
                dims, coords, eff, "sim_bandwidth_gbs")
        if "analytic_efficiency" in wanted:
            xt, yt = self._tensor(xf), self._tensor(yf)
            an = np.stack([flitsim.ANALYTIC[k].bw_eff(xt, yt).cpu().numpy()
                           for k in keys])
            an = an.reshape((len(keys),) + mix_shape)
            if not mix_dims:
                an = an[..., 0]
            out["analytic_efficiency"] = SpaceArray(
                ("protocol",) + mix_dims,
                (keys,) + tuple(self.axes[d].labels for d in mix_dims), an)
        return out

    def _eval_trace(self, wanted, sim: SimConfig) -> Dict[str, SpaceArray]:
        from repro_torch.core import flitsim
        tr_ax = self.axes.get("trace")
        if tr_ax is None:
            raise ValueError("trace metrics ('trace_efficiency', ...) "
                             "need a 'trace' axis")
        keys = self._sim_protocols()
        traces = tr_ax.values           # axis() padded them to a common N
        xs = np.asarray([[100.0 * r for r in t.read_fractions]
                         for t in traces], np.float32)
        ys = 100.0 - xs
        bls = np.asarray([t.backlogs for t in traces], np.float32)
        pert_ax = self.axes.get("protocol_param")
        eff = flitsim.simulate_trace_grid(
            keys, xs, ys, bls,
            perturbations=self._protocol_perturbations(),
            n_flits=self.n_flits, n_accesses=self.n_accesses, sim=sim,
            device=self.device).cpu().numpy()           # [Q, P, T, N]
        # the duration-weighted aggregate is computed host-side in f64
        # with per-trace normalized weights, so a single-phase trace
        # (w == d/d == 1.0 exactly) stays bitwise equal to its static cell
        # through the f32 round trip
        d = np.asarray([t.durations for t in traces], np.float64)
        w = d / d.sum(axis=1, keepdims=True)                    # [T, N]
        agg = np.einsum("qptn,tn->qpt", eff.astype(np.float64),
                        w).astype(np.float32)
        dims: List[str] = ["protocol_param", "protocol", "trace"]
        coords: List[Tuple] = [
            pert_ax.labels if pert_ax is not None else ("baseline",),
            keys, tr_ax.labels]
        if pert_ax is None:
            eff, agg = eff[0], agg[0]
            dims, coords = dims[1:], coords[1:]
        out: Dict[str, SpaceArray] = {}
        if "trace_efficiency" in wanted:
            out["trace_efficiency"] = SpaceArray(tuple(dims), tuple(coords),
                                                 agg)
        if "trace_phase_efficiency" in wanted:
            out["trace_phase_efficiency"] = SpaceArray(
                tuple(dims) + ("phase",),
                tuple(coords) + (tuple(range(eff.shape[-1])),), eff)
        if "trace_bandwidth_gbs" in wanted:
            out["trace_bandwidth_gbs"] = self._phy_dim(
                dims, coords, agg, "trace_bandwidth_gbs")
        return out

    def _eval_pipelining(self, wanted, sim: SimConfig
                         ) -> Dict[str, SpaceArray]:
        from repro_torch.core import flitsim
        k_ax = self.axes.get("k")
        if k_ax is None:
            raise ValueError("the 'utilization' metric needs a 'k' axis")
        u_ax = self.axes.get("ucie_line_ui")
        d_ax = self.axes.get("device_line_ui")
        us = tuple(u_ax.values) if u_ax is not None else (16.0,)
        ds = tuple(d_ax.values) if d_ax is not None else (64.0,)
        util = flitsim._sweep_pipelining_impl(
            k_ax.values, n_lines=self.n_lines, ucie_line_ui=us,
            device_line_ui=ds, sim=sim,
            device=self.device).cpu().numpy()      # [K, U, D]
        dims: List[str] = ["k"]
        coords: List[Tuple] = [k_ax.labels]
        if u_ax is not None:
            dims.append("ucie_line_ui")
            coords.append(u_ax.labels)
        else:
            util = util[:, 0]
        if d_ax is not None:
            dims.append("device_line_ui")
            coords.append(d_ax.labels)
        else:
            util = util[..., 0]
        if "utilization" not in wanted:
            return {}
        return {"utilization": SpaceArray(tuple(dims), tuple(coords),
                                          util)}

    def report(self, spec=None) -> Dict[str, Any]:
        """ONE entry point for every frontier report — see
        :func:`repro_torch.core.report.build_report`."""
        from repro_torch.core.report import build_report
        return build_report(spec, space=self, device=self.device)

    @staticmethod
    def serving_frontier(models=None, qps_points=None,
                         **kwargs) -> Dict[str, Any]:
        """Per-(model, QPS) serving frontier: synthetic serving traces
        evaluated through the ``trace`` axis, winners mapped to catalog
        memory approaches.  Delegates to
        :func:`repro_torch.traces.frontier.serving_frontier` (see there
        for the knobs, ``device=`` among them)."""
        from repro_torch.traces.frontier import (
            DEFAULT_MODELS, DEFAULT_QPS, serving_frontier,
        )
        return serving_frontier(
            models if models is not None else DEFAULT_MODELS,
            qps_points if qps_points is not None else DEFAULT_QPS,
            **kwargs)


# =========================================================================
# Joint analytic-vs-simulated frontier
# =========================================================================


def joint_frontier(n_fracs: int = 21,
                   backlogs: Sequence[float] = (2.0, 8.0, 64.0),
                   shorelines: Sequence[float] = (4.0, 8.0, 16.0),
                   catalog: Optional[Dict[str, Any]] = None,
                   n_flits: int = 2048,
                   constraints=None,
                   sim: Optional[SimConfig] = None,
                   phys: Optional[Sequence[Any]] = None,
                   device=None) -> Dict[str, Any]:
    """Joint (mix x backlog x shoreline) frontier merging the
    flit-simulated efficiency grid with the analytic catalog grid.

    For every catalog system backed by a flit simulator, the analytic
    bandwidth is rescaled by the simulated/analytic efficiency ratio at
    each (mix, backlog) point; bus baselines keep their closed-form
    bandwidth.  The report marks the read-fraction regions where the
    simulation-corrected winner differs from the analytic winner, per
    (backlog, shoreline) cell, each protocol's worst simulated-vs-analytic
    relative error, and the ``sim_bandwidth_gbs`` section (the same
    simulated grid threaded onto each PHY's raw link bandwidth)."""
    from repro_torch.core.selector import approach_key_for, sim_key_for
    fracs = np.linspace(0.0, 1.0, n_fracs)
    space = DesignSpace(
        [axis("read_fraction", fracs),
         axis("backlog", backlogs),
         axis("shoreline_mm", shorelines)],
        catalog=catalog, n_flits=n_flits, sim=sim, device=device)
    metrics = ANALYTIC_METRICS[:1] + SIM_METRICS
    if constraints is not None:
        metrics = metrics + ("power_w",)
    res = space.evaluate(metrics=metrics)
    bw = res["bandwidth_gbs"]                  # [S, M, L]
    sim_eff = res["sim_efficiency"]            # [P, B, M]
    ana = res["analytic_efficiency"]           # [P, M]
    keys = bw.coord("system")
    protocols = sim_eff.coord("protocol")
    ratio = sim_eff.values / np.maximum(ana.values[:, None, :], 1e-9)
    rel_err = {p: float(np.max(np.abs(ratio[i] - 1.0)))
               for i, p in enumerate(protocols)}

    n_b = sim_eff.values.shape[1]
    corrected = np.repeat(bw.values[:, None, :, :], n_b, axis=1)
    for s, key in enumerate(keys):
        simkey = sim_key_for(key)
        if simkey is not None and simkey in protocols:
            p = protocols.index(simkey)
            corrected[s] = bw.values[s][None] * ratio[p][:, :, None]

    feas = res.feasible(constraints, catalog=catalog) \
        if constraints is not None else None
    analytic_best = bw.argbest("system", where=feas).values    # [M, L]
    if feas is not None:
        corrected = np.where(feas.values[:, None, :, :], corrected,
                             -np.inf)
    sim_best_idx = np.argmax(corrected, axis=0)            # [B, M, L]
    sim_best = np.asarray(keys, dtype=object)[sim_best_idx]
    if feas is not None:
        none_cells = ~feas.values.any(axis=0)[None]        # [1, M, L]
        sim_best = np.where(np.broadcast_to(none_cells, sim_best.shape),
                            "(none)", sim_best)
    disagree = sim_best != analytic_best[None]
    regions: List[Dict[str, Any]] = []
    for b, bl in enumerate(sim_eff.coord("backlog")):
        for l, sl in enumerate(bw.coord("shoreline_mm")):
            if not disagree[b, :, l].any():
                continue
            for lo, hi, pair in regimes(
                    [(a, s) for a, s in zip(analytic_best[:, l],
                                            sim_best[b, :, l])],
                    fracs):
                if pair[0] != pair[1]:
                    regions.append({
                        "backlog": float(bl), "shoreline_mm": float(sl),
                        "read_fraction_lo": lo, "read_fraction_hi": hi,
                        "analytic_best": str(pair[0]),
                        "simulated_best": str(pair[1])})
    # -- folded PHY-absolute section: the same simulated grid on each
    # PHY's raw link bandwidth (raw bandwidth is a per-PHY scale)
    if phys is None:
        from repro_torch.core.ucie import (
            UCIE_A_32G_55U, UCIE_A_48G_45U, UCIE_S_32G, UCIE_S_48G_110U)
        phys = [UCIE_S_32G, UCIE_A_32G_55U, UCIE_S_48G_110U,
                UCIE_A_48G_45U]
    proto_arr = np.asarray(protocols, dtype=object)
    sim_section: Dict[str, Any] = {
        "phys": [p.name for p in phys],
        "backlogs": [float(b) for b in backlogs],
        "read_fractions": fracs.tolist(),
        "peak_gbs_by_phy": {},
        "best_protocol_by_phy": {},
        "regimes_by_phy_backlog": {},
    }
    for p in phys:
        gbs = sim_eff.values * np.float32(p.raw_bandwidth_gbs)  # [P, B, M]
        regs_by_bl = {}
        for b, bl in enumerate(sim_eff.coord("backlog")):
            win = proto_arr[np.argmax(gbs[:, b, :], axis=0)]
            regs_by_bl[f"{bl:g}"] = [
                {"read_fraction_lo": lo, "read_fraction_hi": hi,
                 "best": str(lab), "approach": approach_key_for(str(lab))}
                for lo, hi, lab in regimes(win.tolist(), fracs)]
        sim_section["regimes_by_phy_backlog"][p.name] = regs_by_bl
        at70 = proto_arr[int(np.argmax(
            gbs[:, -1, int(round(0.7 * (n_fracs - 1)))]))]
        sim_section["best_protocol_by_phy"][p.name] = str(at70)
        sim_section["peak_gbs_by_phy"][p.name] = float(gbs.max())

    return {
        "read_fractions": fracs.tolist(),
        "backlogs": [float(b) for b in backlogs],
        "shorelines": [float(s) for s in shorelines],
        "keys": list(keys),
        "protocol_rel_err": rel_err,
        "analytic_best": analytic_best.astype(str).tolist(),
        "simulated_best": sim_best.astype(str).tolist(),
        "disagreement_fraction": float(disagree.mean()),
        "disagreement_regions": regions,
        "sim_bandwidth_gbs": sim_section,
    }
