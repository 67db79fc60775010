"""Streamed design-space evaluation — port of :mod:`repro.core.streaming`.

The materialized engines (:meth:`repro_torch.core.space.DesignSpace.
evaluate`) return whole per-cell metric arrays: fine up to ~10^6 cells,
not for the joint [phy x protocol_param x backlog x mix] spaces of
10^6-10^8 cells.  ``evaluate(..., stream=StreamConfig(...))`` is the other
execution mode behind the SAME axes: the cell space is flattened along a
configurable axis order and cut into chunks of at most ``chunk_cells``
cells, one dispatch a chunk on one card, and frontier / argbest /
feasibility resolve as RUNNING reductions:

* per-cell winner codes (one small integer per cell, the only per-cell
  output that ever exists),
* per-label win counts and best metric values, folded on the host.

Sharded: under an initialized ``torch.distributed`` world of ``N`` ranks
(one process a card), ``StreamConfig(devices=N)`` cuts every dispatch
window of ``N * chunk`` cells into one slot a rank, as the reference's
``("chunks",)`` mesh does; each rank marshals, runs and folds only its
own slots, and at the end of the stream one all-reduce SUM of the counts,
one all-reduce MAX (MIN) of the bests and one all-gather of the winner
codes give every rank the same :class:`StreamResult`.  Integer sums and
max / min do not depend on order, so reducing once equals the
reference's reduction per dispatch bit for bit.

Equality contract: the streamed winner labels equal the materialized
``argbest`` on every grid, bit for bit.  A simulated chunk is ONE
one-phase launch of each trace kernel on per-cell parameter columns
(:func:`repro_torch.core.flitsim._run_cells_fixed`), which is the fixed
engine's static cell bit for bit; an analytic chunk is the closed forms of
:func:`repro_torch.core.memsys.run_catalog_program` on per-cell tensors;
f32 arithmetic is IEEE, and ``torch.argmax`` shares numpy's first-max tie
break.  Constraint thresholds go through :func:`_le_threshold_f32` /
:func:`_ge_threshold_f32`, so the f32 comparison on the card admits
exactly the cells the host comparison of the materialized mask admits.

Simulated metrics stream under the FIXED engine only (the adaptive
schedule's early exit depends on the batch, which would break equality
across chunk sizes); control cost with ``DesignSpace(n_flits=...,
n_accesses=...)``.

Overlapped dispatch: the loop marshals chunk ``t+1`` on the host (numpy
gathers into a pinned staging buffer) while up to ``StreamConfig.prefetch``
earlier chunks run on the card.  Each chunk's upload, kernels and the
downloads of its codes, counts and best are enqueued on the current CUDA
stream, followed by a ``torch.cuda.Event``; results retire strictly FIFO
by synchronizing on the oldest event, so the host folds run in EXACTLY the
sequential loop's order and every depth gives identical ``StreamResult``
contents.  On the CPU the same loop runs synchronously.  Dispatch and
overlap telemetry lands in ``flitsim.last_run_info()["stream.*"]``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.core import space as space_mod

__all__ = ["StreamResult", "stream_evaluate"]

#: streamable flit-simulated metrics (reduce dim: ``protocol``)
STREAM_SIM_METRICS: Tuple[str, ...] = ("sim_efficiency",
                                       "sim_bandwidth_gbs")


def _le_threshold_f32(t: float) -> np.float32:
    """Largest f32 ``t32`` with ``v <= t32`` exactly where the host's
    comparison of the materialized mask (an f32 array ``<= t``) admits
    ``v``.  numpy compares an f32 array with a Python float in f32, so
    this is ``np.float32(t)`` there; the search asks numpy itself."""
    t32 = np.float32(t)
    down, up = np.float32(-np.inf), np.float32(np.inf)
    while not bool(np.asarray([t32], np.float32) <= t):
        t32 = np.nextafter(t32, down)
    while bool(np.asarray([np.nextafter(t32, up)], np.float32) <= t):
        t32 = np.nextafter(t32, up)
    return np.float32(t32)


def _ge_threshold_f32(t: float) -> np.float32:
    """Smallest f32 ``t32`` with ``v >= t32`` exactly where the host's
    ``f32 array >= t`` admits ``v`` (see :func:`_le_threshold_f32`)."""
    t32 = np.float32(t)
    down, up = np.float32(-np.inf), np.float32(np.inf)
    while not bool(np.asarray([t32], np.float32) >= t):
        t32 = np.nextafter(t32, up)
    while bool(np.asarray([np.nextafter(t32, down)], np.float32) >= t):
        t32 = np.nextafter(t32, down)
    return np.float32(t32)


def _cell_order(dims_all: Sequence[str], present: Sequence[bool],
                axis_order) -> Tuple[int, ...]:
    """Permutation of cell-dim positions realizing ``axis_order``.

    ``axis_order`` must be a permutation of the PRESENT cell axes; absent
    (size-1 placeholder) dims are appended at the end — they carry one
    index, so their position never changes the enumeration.
    """
    if axis_order is None:
        return tuple(range(len(dims_all)))
    avail = [d for d, p in zip(dims_all, present) if p]
    if sorted(axis_order) != sorted(avail):
        raise ValueError(
            f"StreamConfig.axis_order must be a permutation of the "
            f"space's cell axes {avail}, got {list(axis_order)}")
    order = [dims_all.index(d) for d in axis_order]
    order += [i for i, p in enumerate(present) if not p]
    return tuple(order)


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Reduced output of one streamed evaluation.

    ``winners`` is the ONLY per-cell artifact: a
    :class:`~repro_torch.core.space.SpaceArray` of winner labels whose dims
    and coords equal the materialized ``evaluate()[metric].argbest(
    reduce_dim, mode)`` (cells where the constraints admit nothing read
    ``"(none)"``).  ``win_counts`` / ``best_by_label`` are the running
    reductions (win counts sum to ``n_cells``; bests are NaN for labels
    the constraints never admit).  ``peak_cells_per_chunk`` is the memory
    budget: the most joint cells resident per dispatch.  ``compiles`` is
    kept for the reference's shape and reads 0: the port compiles nothing
    per chunk shape (its kernels are built once per process).
    """

    metric: str
    reduce_dim: str                 # "protocol" | "system"
    mode: str                       # "max" | "min"
    labels: Tuple[str, ...]
    winners: Any                    # SpaceArray of winner labels
    win_counts: Dict[str, int]
    best_by_label: Dict[str, float]
    n_cells: int                    # total joint cells reduced
    n_stream_cells: int             # streamed (chunked) cell-space size
    n_dispatches: int
    chunk_cells: int                # streamed cells per dispatch
    peak_cells_per_chunk: int       # peak joint cells per dispatch
    devices: int
    compiles: int

    def frontier(self) -> Any:
        """The winner-label array (argbest alias, mirroring
        :meth:`repro_torch.core.space.SpaceResult.frontier`)."""
        return self.winners


def _shards(stream) -> Tuple[int, int]:
    """``(devices, rank)``: the ranks ``stream`` is sharded over and this
    process's slot.  ``devices`` None or 1 is one card, in a world or
    not; any other count must be the size of the initialized world."""
    want = 1 if stream.devices is None else int(stream.devices)
    if want == 1:
        return 1, 0
    how = (f"start {want} ranks with repro_torch.launch.mesh.spawn(fn, "
           f"{want}) or torchrun --nproc-per-node {want}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"StreamConfig(devices={want}) shards the stream over {want} "
            f"ranks, but no torch.distributed world is initialized (this "
            f"process is 1 rank); {how}")
    world = dist.get_world_size()
    if world != want:
        raise ValueError(
            f"StreamConfig(devices={want}) does not match the world of "
            f"{world} ranks: devices must be 1 (each rank streams the "
            f"whole space) or the world's size; {how}")
    return want, dist.get_rank()


def _dispatch_plan(n_cells: int, chunk_cells: int,
                   devices: int) -> Tuple[int, int, int]:
    """``(chunk, step, dispatches)`` for a flat cell space cut into
    windows of ``step = devices * chunk`` cells, ``chunk`` a rank (the
    reference's plan)."""
    chunk = max(1, min(int(chunk_cells), -(-n_cells // devices)))
    step = devices * chunk
    return chunk, step, -(-n_cells // step)


def _chunk_ids(lo: int, width: int, n_cells: int):
    """Global cell ids + validity for the cells [lo, lo+width) of one
    slot; cells past the space pad by repeating its last cell (the
    reference's tail), so a slot past the end is all padding."""
    ids = np.arange(lo, lo + width, dtype=np.int64)
    valid = (ids < n_cells).astype(np.int32)
    return np.minimum(ids, n_cells - 1), valid


def _reduce_shards(devices: int, chunk: int, sums: np.ndarray,
                   best: np.ndarray, is_max: bool, codes: np.ndarray,
                   n_cells: int):
    """Every rank's folds combined: one all-reduce SUM of the int64
    ``sums``, one all-reduce MAX (MIN unless ``is_max``) of the f64
    ``best`` and one all-gather of each rank's int16 ``codes`` (its slot
    of every window, ``[dispatches * chunk, ...]``), reassembled in global
    cell order; returns ``(sums, best, codes[:n_cells], telemetry)``.
    NCCL takes tensors on this rank's card, gloo host tensors."""
    if devices == 1:
        return sums, best, codes[:n_cells], {}
    t0 = time.perf_counter()
    nccl = dist.get_backend() == "nccl"
    dev = (torch.device("cuda", torch.cuda.current_device()) if nccl
           else torch.device("cpu"))
    s = torch.from_numpy(np.ascontiguousarray(sums)).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(best)).to(dev)
    dist.all_reduce(s, op=dist.ReduceOp.SUM)
    dist.all_reduce(b, op=dist.ReduceOp.MAX if is_max
                    else dist.ReduceOp.MIN)
    # the codes travel as bytes: NCCL has no 16-bit integer type
    mine = torch.from_numpy(np.ascontiguousarray(codes).reshape(-1)
                            .view(np.uint8)).to(dev)
    parts = [torch.empty_like(mine) for _ in range(devices)]
    dist.all_gather(parts, mine)
    trail = codes.shape[1:]
    grid = torch.stack(parts).cpu().numpy().view(np.int16).reshape(
        (devices, -1, chunk) + trail)       # [rank, window, slot cell, ...]
    out = np.swapaxes(grid, 0, 1).reshape((-1,) + trail)[:n_cells]
    info = {"devices": devices, "rank": dist.get_rank(),
            "reduce_s": time.perf_counter() - t0,
            "reduce_bytes": (s.numel() * s.element_size()
                             + b.numel() * b.element_size()
                             + devices * mine.numel()),
            "transport": "device" if nccl else "host"}
    return s.cpu().numpy(), b.cpu().numpy(), out, info


def _winner_array(codes: np.ndarray, shape_perm, order, full, labels_ext):
    """Reduced winner codes -> a SpaceArray equal to the materialized
    argbest: reshape in dispatch order, transpose back to canonical order,
    gather labels, drop absent (size-1) dims."""
    trail = codes.shape[1:]         # broadcast dims appended after cells
    grid = codes.reshape(shape_perm + trail)
    inv = tuple(int(i) for i in np.argsort(np.asarray(order)))
    grid = np.transpose(grid, inv + tuple(len(order) + i
                                          for i in range(len(trail))))
    lab = labels_ext[grid.astype(np.int64)]
    if trail:                       # [cells..., F] -> [pert, F, rest...]
        lab = np.moveaxis(lab, -1, 1)
    for axpos in reversed(range(len(full))):
        if not full[axpos][1]:
            lab = np.take(lab, 0, axis=axpos)
    dims = tuple(n for n, p, _ in full if p)
    coords = tuple(c for _, p, c in full if p)
    return space_mod.SpaceArray(dims, coords,
                                np.asarray(lab, dtype=object))


class _Dispatcher:
    """The bounded in-flight window of a streamed evaluation on one device.

    ``layout`` names the f32 input segments of a chunk and their 2-D
    shapes; :meth:`run` calls ``marshal(t, views)`` to fill a staging
    buffer's numpy views (pinned host memory on a card, ``prefetch``
    slots, pad rows left zero), uploads it in one copy, calls
    ``compute(device_views)`` for the chunk's device results and brings
    them back, and calls ``fold(t, host_results)`` on the oldest chunk
    whenever ``prefetch`` chunks are in flight.  On a card everything is
    enqueued on the current stream and the retire synchronizes on the
    oldest chunk's event; on the CPU each chunk completes at once."""

    def __init__(self, device, prefetch: int,
                 layout: Sequence[Tuple[str, Tuple[int, int]]]):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.prefetch = int(prefetch)
        self.layout = list(layout)
        self.size = sum(r * c for _, (r, c) in self.layout)
        self.slots: List[torch.Tensor] = []
        self.outs: Dict[int, List[torch.Tensor]] = {}
        self.marshal_s = self.overlap_s = 0.0

    def _views(self, flat):
        views, at = {}, 0
        for name, (r, c) in self.layout:
            views[name] = flat[at:at + r * c].view(r, c)
            at += r * c
        return views

    def _staging(self, t: int) -> torch.Tensor:
        if not self.cuda:
            return torch.zeros(self.size, dtype=torch.float32)
        slot = t % self.prefetch
        while len(self.slots) <= slot:
            self.slots.append(torch.zeros(self.size, dtype=torch.float32,
                                          pin_memory=True))
        return self.slots[slot]

    def _download(self, t: int, results) -> List[torch.Tensor]:
        if not self.cuda:
            return list(results)
        slot = t % self.prefetch
        if slot not in self.outs:
            self.outs[slot] = [torch.empty(r.shape, dtype=r.dtype,
                                           pin_memory=True) for r in results]
        host = self.outs[slot]
        for h, r in zip(host, results):
            h.copy_(r, non_blocking=True)
        return host

    def run(self, n_dispatch: int, marshal: Callable, compute: Callable,
            fold: Callable) -> None:
        inflight: Any = collections.deque()  # FIFO of (t, host, event)

        def retire():
            t, host, event = inflight.popleft()
            if event is not None:
                event.synchronize()
            fold(t, [h.numpy() for h in host])

        for t in range(n_dispatch):
            m0 = time.perf_counter()
            staging = self._staging(t)
            marshal(t, {k: v.numpy() for k, v in
                        self._views(staging).items()})
            dm = time.perf_counter() - m0
            self.marshal_s += dm
            # overlapped: the card still ran an earlier chunk when the
            # marshal ended (so it was busy all through it)
            if inflight and inflight[-1][2] is not None \
                    and not inflight[-1][2].query():
                self.overlap_s += dm
            dev_flat = staging.to(self.device, non_blocking=True)
            host = self._download(t, compute(self._views(dev_flat)))
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            inflight.append((t, host, event))
            while len(inflight) >= self.prefetch:
                retire()
        while inflight:
            retire()

    @property
    def overlap_frac(self) -> float:
        return self.overlap_s / self.marshal_s if self.marshal_s else 0.0


# =========================================================================
# Simulated metrics (stream.sim family)
# =========================================================================


def _stream_sim(space, metric: str, sim, stream, devices: int,
                rank: int) -> StreamResult:
    from repro_torch.core import flitsim
    from repro_torch.kernels.flit_sim.ref import ASYM_ROWS, SYM_ROWS
    if sim.mode != "fixed":
        raise ValueError(
            "streaming evaluation runs the fixed-horizon cores only (the "
            "adaptive early-exit schedule depends on batch shape, which "
            "would break chunk-size invariance); got "
            f"SimConfig(mode={sim.mode!r}).  Control cost via "
            "DesignSpace(n_flits=..., n_accesses=...) instead")
    if stream.mode not in (None, "max"):
        raise ValueError("simulated streaming frontiers maximize "
                         f"efficiency; got StreamConfig(mode="
                         f"{stream.mode!r})")
    keys = space._sim_protocols()
    x, y, mix_dims = space._mix_arrays()
    mix_shape = x.shape
    xf = np.asarray(x, np.float32).reshape(-1)
    yf = np.asarray(y, np.float32).reshape(-1)
    if np.any(xf < 0) or np.any(yf < 0) or np.any(xf + yf <= 0):
        raise ValueError("invalid traffic mix in the lowered grid")
    bl_ax = space.axes.get("backlog")
    backlogs = np.asarray(bl_ax.values if bl_ax is not None
                          else [space.default_backlog], np.float32)
    pert_ax = space.axes.get("protocol_param")
    perts = ([dict(p) for _, p in pert_ax.values]
             if pert_ax is not None else [{}])
    # perturbation validation: simulate_grid's
    keys, perts = flitsim._checked(keys, perts)
    sym_keys = [k for k in keys if k in flitsim.SYMMETRIC_PARAMS]
    asym_keys = [k for k in keys if k in flitsim.ASYMMETRIC_PARAMS]

    phy_ax = space.axes.get("phy")
    if metric == "sim_bandwidth_gbs":
        if phy_ax is not None:
            phys = list(phy_ax.values)
            has_phy_dim = True
        elif space.phy is not None:
            phys = [space.phy]
            has_phy_dim = False
        else:
            raise ValueError(
                "the 'sim_bandwidth_gbs' metric threads the PHY's raw "
                "link bandwidth into the simulated efficiency — add a "
                "'phy' axis or pass DesignSpace(phy=...)")
        raw = np.asarray([p.raw_bandwidth_gbs for p in phys], np.float32)
        phy_names: Tuple[str, ...] = tuple(p.name for p in phys)
    else:
        has_phy_dim, phy_names = False, ("-",)
        raw = np.ones(1, np.float32)
    n_phys = raw.shape[0]

    # -- flat cell space: [protocol_param x backlog x mix...] ------------
    dims_all = ["protocol_param", "backlog"] + list(mix_dims)
    sizes = [len(perts), backlogs.shape[0]]
    present = [pert_ax is not None, bl_ax is not None]
    if mix_dims:
        sizes += list(mix_shape)
        present += [True] * len(mix_dims)
    order = _cell_order(dims_all, present, stream.axis_order)
    shape_perm = tuple(sizes[i] for i in order)
    n_cells = int(np.prod(shape_perm))
    chunk, step, n_dispatch = _dispatch_plan(n_cells, stream.chunk_cells,
                                             devices)

    # perturbation-major parameter stacks (row = q * P_fam + key index,
    # simulate_grid's layout): [fields, Q * P_fam] host arrays, gathered
    # per chunk into per-cell columns
    p_sym, p_asym = len(sym_keys), len(asym_keys)
    sym_fields = [f.name for f in
                  dataclasses.fields(flitsim.SymmetricFlitParams)]
    asym_fields = [f.name for f in
                   dataclasses.fields(flitsim.AsymmetricLaneParams)]
    # each perturbed parameter set built once (a rank builds them all)
    sym_sets = [flitsim.SYMMETRIC_PARAMS[k].perturbed(p)
                for p in perts for k in sym_keys]
    asym_sets = [flitsim.ASYMMETRIC_PARAMS[k].perturbed(p)
                 for p in perts for k in asym_keys]
    sym_host = np.asarray([[getattr(q, f) for q in sym_sets]
                           for f in sym_fields],
                          np.float32).reshape(len(sym_fields), -1)
    asym_host = np.asarray([[getattr(q, f) for q in asym_sets]
                            for f in asym_fields],
                           np.float32).reshape(len(asym_fields), -1)
    # the [C, P] efficiency columns come sym-then-asym; put them in key order
    col_src = [sym_keys.index(k) if k in flitsim.SYMMETRIC_PARAMS
               else p_sym + asym_keys.index(k) for k in keys]
    n_protocols = len(keys)
    n_flits, n_accesses = int(space.n_flits), int(space.n_accesses)
    cs, ca = chunk * p_sym, chunk * p_asym
    layout = [("valid", (1, chunk))]
    if p_sym:
        layout += [("sp", (SYM_ROWS, cs)), ("sx", (1, cs)), ("sy", (1, cs)),
                   ("sb", (1, cs))]
    if p_asym:
        layout += [("ap", (ASYM_ROWS, ca)), ("ax", (1, ca)),
                   ("ay", (1, ca))]
    a_sym = np.arange(p_sym, dtype=np.int64)
    a_asym = np.arange(p_asym, dtype=np.int64)
    dev = space.device
    raw_dev = torch.as_tensor(raw, device=dev)
    perm = torch.as_tensor(col_src, device=dev)
    identity = col_src == list(range(n_protocols))
    labels_dev = torch.arange(n_protocols, device=dev)

    def marshal(t, v):
        ids, valid = _chunk_ids(t * step + rank * chunk, chunk, n_cells)
        multi = np.unravel_index(ids, shape_perm)
        by_dim = {dims_all[order[j]]: multi[j] for j in range(len(order))}
        q_idx = by_dim["protocol_param"]
        b_idx = by_dim["backlog"]
        if mix_dims:
            m_idx = np.ravel_multi_index(
                tuple(by_dim[d] for d in mix_dims), mix_shape)
        else:
            m_idx = np.zeros(chunk, np.int64)
        v["valid"][0] = valid
        if p_sym:
            rows = (q_idx[:, None] * p_sym + a_sym).reshape(-1)
            np.take(sym_host, rows, axis=1, out=v["sp"][:len(sym_fields)],
                    mode="clip")
            m_rep = np.repeat(m_idx, p_sym)
            np.take(xf, m_rep, out=v["sx"][0], mode="clip")
            np.take(yf, m_rep, out=v["sy"][0], mode="clip")
            np.take(backlogs, np.repeat(b_idx, p_sym), out=v["sb"][0],
                    mode="clip")
        if p_asym:
            rows = (q_idx[:, None] * p_asym + a_asym).reshape(-1)
            np.take(asym_host, rows, axis=1,
                    out=v["ap"][:len(asym_fields)], mode="clip")
            m_rep = np.repeat(m_idx, p_asym)
            np.take(xf, m_rep, out=v["ax"][0], mode="clip")
            np.take(yf, m_rep, out=v["ay"][0], mode="clip")

    def compute(v):
        s_eff, a_eff = flitsim._run_cells_fixed(
            (v["sp"], v["sx"], v["sy"], v["sb"]) if p_sym else None,
            (v["ap"], v["ax"], v["ay"]) if p_asym else None,
            n_flits=n_flits, n_accesses=n_accesses)
        cols = ([s_eff.view(chunk, p_sym)] if p_sym else []) \
            + ([a_eff.view(chunk, p_asym)] if p_asym else [])
        eff = torch.cat(cols, dim=1)
        if not identity:
            eff = eff.index_select(1, perm)                 # [C, P]
        m = eff[:, None, :] * raw_dev[None, :, None]        # [C, F, P]
        codes = torch.argmax(m, dim=2)                      # [C, F]
        ok = (v["valid"][0] > 0)[:, None, None]
        counts = ((codes[..., None] == labels_dev) & ok).sum(dim=0)
        best = m.masked_fill(~ok, float("-inf")).amax(dim=(0, 1))
        return codes.to(torch.int16), counts, best

    # this rank's slot of every window (the codes of its padded cells too)
    codes_out = np.empty((n_dispatch * chunk, n_phys), np.int16)
    counts_total = np.zeros((n_phys, n_protocols), np.int64)
    best_total = np.full((n_protocols,), -np.inf, np.float64)

    def fold(t, host):
        codes, counts, best = host
        codes_out[t * chunk:(t + 1) * chunk] = codes
        counts_total[...] += counts.astype(np.int64)
        np.maximum(best_total, best.astype(np.float64), out=best_total)

    t0 = time.perf_counter()
    disp = _Dispatcher(dev, stream.prefetch, layout)
    disp.run(n_dispatch, marshal, compute, fold)
    counts_total, best_total, codes_out, shard = _reduce_shards(
        devices, chunk, counts_total, best_total, True, codes_out, n_cells)
    flitsim._record_stream(
        "stream.sim", dispatches=n_dispatch, prefetch=disp.prefetch,
        pad_cells=n_dispatch * step - n_cells,
        overlap_frac=disp.overlap_frac, cells=n_cells,
        elapsed_s=time.perf_counter() - t0, marshal_s=disp.marshal_s,
        shard=shard)

    pert_labels = (tuple(pert_ax.labels) if pert_ax is not None
                   else ("baseline",))
    bl_labels = (tuple(bl_ax.labels) if bl_ax is not None
                 else (space.default_backlog,))
    full = [("protocol_param", pert_ax is not None, pert_labels),
            ("phy", has_phy_dim, phy_names),
            ("backlog", bl_ax is not None, bl_labels)]
    full += [(d, True, tuple(space.axes[d].labels)) for d in mix_dims]
    winners = _winner_array(codes_out, shape_perm, order, full,
                            np.asarray(keys, dtype=object))
    per_label = counts_total.sum(axis=0)
    return StreamResult(
        metric=metric, reduce_dim="protocol", mode="max", labels=keys,
        winners=winners,
        win_counts={k: int(per_label[i]) for i, k in enumerate(keys)},
        best_by_label={k: float(best_total[i])
                       for i, k in enumerate(keys)},
        n_cells=n_cells * n_phys, n_stream_cells=n_cells,
        n_dispatches=n_dispatch, chunk_cells=chunk,
        peak_cells_per_chunk=chunk * n_phys, devices=devices, compiles=0)


# =========================================================================
# Analytic catalog metrics (stream.catalog family)
# =========================================================================


def _knee_admissibility(space, items, cons, sim):
    """``[S, K]`` backlog-knee admissibility + the cell dim ``K`` indexes
    (``None`` = broadcast) — mirror of ``SpaceResult._knee_mask``."""
    from repro_torch.core import flitsim
    from repro_torch.core import selector as selector_mod
    keys = [k for k, _ in items]
    simkeys = [selector_mod.sim_key_for(k) for k in keys]
    budget = cons.max_backlog_knee
    if budget is None:
        return np.ones((len(keys), 1), bool), None
    cfg = space.axes.get("workload_config")
    mix_ax = space.axes.mix_axis()
    if cfg is not None:
        mixes = [(w.x, w.y) for _, w in cfg.values]
        dim = "workload_config"
    elif mix_ax is not None and space_mod.OWN_MIX not in mix_ax.values:
        if mix_ax.name == "read_fraction":
            mixes = [(100.0 * r, 100.0 - 100.0 * r)
                     for r in mix_ax.values]
        else:
            mixes = list(mix_ax.values)
        dim = mix_ax.name
    else:
        knees = selector_mod.default_knees(space.device)
        sub = np.asarray([sk is None or knees[sk] <= budget
                          for sk in simkeys], bool)
        return sub[:, None], None
    per = flitsim.backlog_knees(mixes=mixes, per_mix=True, sim=sim,
                                device=space.device)
    sub = np.ones((len(keys), len(mixes)), bool)
    for i, sk in enumerate(simkeys):
        if sk is not None:
            sub[i] = per[sk] <= budget
    return sub, dim


def _stream_catalog(space, metric: str, sim, stream, devices: int,
                    rank: int) -> StreamResult:
    from repro_torch.core import flitsim, memsys
    from repro_torch.core import selector as selector_mod
    if (space.axes.get("catalog_param") is not None
            or space.axes.get("phy") is not None
            or space.phy is not None):
        raise ValueError(
            "streaming analytic evaluation covers the (workload_config, "
            "mix/read_fraction, shoreline_mm) cell axes over the default "
            "or custom catalog; catalog_param / phy axes run through the "
            "materialized evaluate() path")
    items = (memsys.default_catalog_items() if space.catalog is None
             else tuple(space.catalog.items()))
    keys = tuple(k for k, _ in items)
    n_systems = len(items)
    mode = stream.mode if stream.mode is not None else (
        "min" if metric in ("pj_per_bit", "power_w") else "max")
    x, y, mix_dims = space._mix_arrays()
    mix_shape = x.shape
    xf = np.asarray(x, np.float32).reshape(-1)
    yf = np.asarray(y, np.float32).reshape(-1)
    sl_ax = space.axes.get("shoreline_mm")
    sls = np.asarray(sl_ax.values if sl_ax is not None
                     else [space.default_shoreline_mm], np.float32)

    dims_all = list(mix_dims) + ["shoreline_mm"]
    sizes = (list(mix_shape) if mix_dims else []) + [sls.shape[0]]
    present = [True] * len(mix_dims) + [sl_ax is not None]
    order = _cell_order(dims_all, present, stream.axis_order)
    shape_perm = tuple(sizes[i] for i in order)
    n_cells = int(np.prod(shape_perm))
    chunk, step, n_dispatch = _dispatch_plan(n_cells, stream.chunk_cells,
                                             devices)

    cons = stream.constraints
    if cons is None:
        static = np.ones(n_systems, bool)
        knee_adm, knee_dim = np.ones((n_systems, 1), bool), None
        thr = np.asarray([np.inf, -np.inf], np.float32)
    else:
        static = np.asarray(selector_mod.system_mask(
            items, dataclasses.replace(cons, max_backlog_knee=None),
            device=space.device), bool)
        knee_adm, knee_dim = _knee_admissibility(space, items, cons, sim)
        thr = np.asarray(
            [_le_threshold_f32(cons.max_power_w)
             if cons.max_power_w is not None else np.float32(np.inf),
             _ge_threshold_f32(cons.required_bandwidth_gbs)
             if cons.required_bandwidth_gbs is not None
             else np.float32(-np.inf)], np.float32)

    is_max = mode == "max"
    fill = float("-inf") if is_max else float("inf")
    dev = space.device
    thr_dev = torch.as_tensor(thr, device=dev)
    labels_dev = torch.arange(n_systems, device=dev)
    layout = [("valid", (1, chunk)), ("xs", (1, chunk)), ("ys", (1, chunk)),
              ("sls", (1, chunk)), ("adm", (n_systems, chunk))]

    def marshal(t, v):
        ids, valid = _chunk_ids(t * step + rank * chunk, chunk, n_cells)
        multi = np.unravel_index(ids, shape_perm)
        by_dim = {dims_all[order[j]]: multi[j] for j in range(len(order))}
        if mix_dims:
            m_idx = np.ravel_multi_index(
                tuple(by_dim[d] for d in mix_dims), mix_shape)
        else:
            m_idx = np.zeros(chunk, np.int64)
        k_idx = by_dim[knee_dim] if knee_dim is not None else \
            np.zeros(chunk, np.int64)
        v["valid"][0] = valid
        np.take(xf, m_idx, out=v["xs"][0], mode="clip")
        np.take(yf, m_idx, out=v["ys"][0], mode="clip")
        np.take(sls, by_dim["shoreline_mm"], out=v["sls"][0], mode="clip")
        v["adm"][...] = static[:, None] & knee_adm[:, k_idx]     # [S, C]

    def compute(v):
        bw, pjb, pw, gpw = memsys.run_catalog_program(
            items, v["xs"][0], v["ys"][0], v["sls"][0])       # [S, C]
        vals = {"bandwidth_gbs": bw, "pj_per_bit": pjb, "power_w": pw,
                "gbs_per_watt": gpw}[metric]
        ok = (v["adm"] > 0) & (pw <= thr_dev[0]) & (bw >= thr_dev[1])
        masked = vals.masked_fill(~ok, fill)
        codes = (torch.argmax if is_max else torch.argmin)(masked, dim=0)
        any_ok = ok.any(dim=0)
        codes = torch.where(any_ok, codes, -1)                 # [C]
        vcell = v["valid"][0] > 0
        counts = ((codes[:, None] == labels_dev)
                  & vcell[:, None]).sum(dim=0)                 # [S]
        none_ct = (vcell & ~any_ok).sum().reshape(1)
        red = masked.masked_fill(~vcell[None, :], fill)
        best = red.amax(dim=1) if is_max else red.amin(dim=1)
        return codes.to(torch.int16), counts, best, none_ct

    # this rank's slot of every window; the counts, then the (none) count
    codes_out = np.empty(n_dispatch * chunk, np.int16)
    counts_total = np.zeros(n_systems + 1, np.int64)
    best_total = np.full(n_systems, fill, np.float64)
    acc = np.maximum if is_max else np.minimum

    def fold(t, host):
        codes, counts, best, none_ct = host
        codes_out[t * chunk:(t + 1) * chunk] = codes
        counts_total[:n_systems] += counts.astype(np.int64)
        counts_total[n_systems] += np.int64(none_ct[0])
        acc(best_total, best.astype(np.float64), out=best_total)

    t0 = time.perf_counter()
    disp = _Dispatcher(dev, stream.prefetch, layout)
    disp.run(n_dispatch, marshal, compute, fold)
    counts_total, best_total, codes_out, shard = _reduce_shards(
        devices, chunk, counts_total, best_total, is_max, codes_out,
        n_cells)
    flitsim._record_stream(
        "stream.catalog", dispatches=n_dispatch, prefetch=disp.prefetch,
        pad_cells=n_dispatch * step - n_cells,
        overlap_frac=disp.overlap_frac, cells=n_cells,
        elapsed_s=time.perf_counter() - t0, marshal_s=disp.marshal_s,
        shard=shard)

    full = [(d, True, tuple(space.axes[d].labels)) for d in mix_dims]
    sl_labels = (tuple(sl_ax.labels) if sl_ax is not None
                 else (space.default_shoreline_mm,))
    full += [("shoreline_mm", sl_ax is not None, sl_labels)]
    winners = _winner_array(codes_out, shape_perm, order, full,
                            np.asarray(keys + ("(none)",), dtype=object))
    win_counts = {k: int(counts_total[i]) for i, k in enumerate(keys)}
    if cons is not None:
        win_counts["(none)"] = int(counts_total[n_systems])
    return StreamResult(
        metric=metric, reduce_dim="system", mode=mode, labels=keys,
        winners=winners, win_counts=win_counts,
        best_by_label={k: (float(best_total[i])
                           if best_total[i] != fill else float("nan"))
                       for i, k in enumerate(keys)},
        n_cells=n_cells, n_stream_cells=n_cells,
        n_dispatches=n_dispatch, chunk_cells=chunk,
        peak_cells_per_chunk=chunk, devices=devices, compiles=0)


def stream_evaluate(space, metrics, sim, stream) -> StreamResult:
    """Dispatch one streamed metric reduction (the ``stream=`` path of
    :meth:`repro_torch.core.space.DesignSpace.evaluate`)."""
    if metrics is None:
        raise ValueError(
            "streaming evaluation reduces exactly ONE metric per call; "
            "pass metrics=('sim_efficiency',) (or another single metric) "
            "explicitly")
    if isinstance(metrics, str):
        metric = metrics
    else:
        wanted = tuple(metrics)
        if len(wanted) != 1:
            raise ValueError(
                "streaming evaluation reduces exactly ONE metric per "
                f"call, got {wanted}; run one stream per metric")
        metric = wanted[0]
    sim = sim if sim is not None else space_mod.FIXED_SIM
    devices, rank = _shards(stream)
    for name in ("trace", "k", "ucie_line_ui", "device_line_ui"):
        if space.axes.get(name) is not None:
            raise ValueError(
                f"streaming evaluation does not cover the {name!r} axis "
                "yet; use the materialized evaluate() path")
    if metric in STREAM_SIM_METRICS:
        if stream.constraints is not None:
            raise ValueError(
                "StreamConfig.constraints stream through the analytic "
                "metrics only; the simulated frontier mirrors the "
                "materialized unconstrained argbest")
        return _stream_sim(space, metric, sim, stream, devices, rank)
    if metric in space_mod.ANALYTIC_METRICS:
        return _stream_catalog(space, metric, sim, stream, devices, rank)
    raise ValueError(
        f"metric {metric!r} is not streamable; choose from "
        f"{STREAM_SIM_METRICS + space_mod.ANALYTIC_METRICS}")
