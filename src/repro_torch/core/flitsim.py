"""Flit-level link simulators — port of :mod:`repro.core.flitsim`.

Validates the paper's closed-form bandwidth-efficiency expressions with a
cycle-level simulation of slot scheduling.  Three simulator families:

  * symmetric  — slot/granule scheduler for approaches C/D/E (256 B flits
    per direction per cycle; headers first, data fills the rest);
  * asymmetric — lane-group/UI scheduler for approaches A/B;
  * pipelining — Appendix Fig 13: k LPDDR6 devices time-multiplexed
    behind one UCIe link (link utilization saturates at k = 4).

Parameter *stacks* are frozen dataclasses whose fields are ``[P]`` f32
tensors, one entry per protocol (optionally folded with perturbations).

Execution modes (:class:`repro_torch.core.space.SimConfig`):

* ``mode="fixed"`` — the full fixed horizon as one eager PyTorch loop per
  family over the whole ``[P, B, M]`` grid, averaging over the warm
  window (the last three quarters); the numerics every golden pins.
* ``mode="adaptive"`` — the reference's adaptive schedule on the fused
  kernels of :mod:`repro_torch.kernels.flit_sim`:

  - asymmetric grids run the period-exact detector (ONE
    ``asymmetric_periodic`` launch: ~2 credit periods observed, lane
    clocks extrapolated to the horizon), falling back to a chunked plain
    PyTorch core on mostly aperiodic grids;
  - symmetric grids whose largest backlog is at most
    ``SYM_PERIODIC_MAX_BACKLOG`` first try the exact ``symmetric_periodic``
    detector; everything else runs the chunked schedule of the
    reference's ``engine="pallas"`` (the port has no XLA ``while_loop``
    core) in ONE ``symmetric_run`` launch, which advances chunk after
    chunk and takes the early exit on the card;
  - pipelining grids run the same way, one ``pipelining_run`` launch,
    while the device ready table fits the kernel's ``PIPE_MAX_K`` rows;
    wider tables run a chunked plain PyTorch core.

  Unconverged stragglers (large grids only) and undetected periodic cells
  are re-simulated exactly at the full fixed horizon.

Trace-scan mode (:func:`simulate_trace_grid`, the design space's ``trace``
axis) runs each family's phases back to back with the queue/credit state
carried across phase boundaries, in ONE launch per family on the card
(the ``symmetric_trace`` and ``asymmetric_trace`` kernels) and in their
plain versions on the CPU.  A one-phase trace is the fixed engine's static
cell bit for bit, so :func:`_run_cells_fixed` runs flat per-cell
fixed-horizon grids (each cell its own parameter column, mix and backlog;
the streamed chunks of :mod:`repro_torch.core.streaming`) as ONE launch of
each trace kernel.

Every entry point takes ``device=`` (default ``"cuda"``; see
:mod:`repro_torch.device`).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.protocols.chi_ucie import CHIOnUCIe
from repro_torch.core.protocols.cxl_mem import CXLMemOnUCIe
from repro_torch.core.protocols.cxl_mem_opt import CXLMemOptOnUCIe
from repro_torch.core.protocols.hbm_ucie import HBMOnUCIe
from repro_torch.core.protocols.lpddr6_ucie import LPDDR6OnUCIe
from repro_torch.core.space import FIXED_SIM, SimConfig

F32 = torch.float32


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, np.float32), device=device)


def _check_mix(x: float, y: float) -> None:
    """Reject degenerate mixes loudly (the cores would emit NaN)."""
    if x < 0 or y < 0 or x + y <= 0:
        raise ValueError(f"invalid traffic mix x={x} y={y}: need x, y >= 0 "
                         "and x + y > 0")


def apply_perturbation(obj, pert: Mapping[str, float]):
    """Multiplicatively scale the named fields of a frozen dataclass
    (fields ``obj`` doesn't have are ignored — validate upstream)."""
    fields = {f.name for f in dataclasses.fields(type(obj))}
    rep = {k: float(getattr(obj, k)) * float(s)
           for k, s in pert.items() if k in fields}
    return dataclasses.replace(obj, **rep) if rep else obj


class _Stackable:
    """Mixin: stack N parameter sets into one dataclass of ``[N]`` f32
    tensors."""

    @classmethod
    def stack(cls, params: Sequence["_Stackable"], device):
        names = [f.name for f in dataclasses.fields(cls)]
        return cls(*[_f32([getattr(p, n) for p in params], device)
                     for n in names])

    def perturbed(self, pert: Mapping[str, float]) -> "_Stackable":
        return apply_perturbation(self, pert)

    def map(self, fn):
        """The same stack with ``fn`` applied to every field tensor."""
        return type(self)(*[fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)])


@dataclasses.dataclass(frozen=True)
class SymmetricFlitParams(_Stackable):
    """Slot geometry for a symmetric flit protocol."""

    g_slots: Any                 # payload-capable slots per flit
    h_slots: Any                 # header-only slots per flit
    reqs_per_h: Any              # requests fitting the header slot
    resps_per_h: Any
    reqs_per_g: Any              # requests per payload slot (overflow)
    resps_per_g: Any
    data_slots_per_line: Any     # slots per 64 B line
    slot_bits: Any               # payload slot size in bits
    flit_bits: Any = 2048        # 256 B
    #: in-flight read-return credit, in flits' worth of payload slots
    credit_lines: Any = 8.0
    #: memory-side write-buffer depth, in flits' worth of payload slots
    #: (defaults to ``credit_lines``)
    write_buffer_lines: Any = None

    def __post_init__(self):
        if self.write_buffer_lines is None:
            object.__setattr__(self, "write_buffer_lines",
                               self.credit_lines)

    @classmethod
    def cxl_unopt(cls) -> "SymmetricFlitParams":
        # 1 H + 14 G usable; 16 B slots; 1 req / 2 resp per slot.
        return cls(g_slots=14, h_slots=1, reqs_per_h=1, resps_per_h=2,
                   reqs_per_g=1, resps_per_g=2, data_slots_per_line=4,
                   slot_bits=128)

    @classmethod
    def cxl_opt(cls) -> "SymmetricFlitParams":
        # 15 G + 1 HS (10 B, headers only); 1 req / 4 resp per slot.
        return cls(g_slots=15, h_slots=1, reqs_per_h=1, resps_per_h=4,
                   reqs_per_g=1, resps_per_g=4, data_slots_per_line=4,
                   slot_bits=128)

    @classmethod
    def chi(cls) -> "SymmetricFlitParams":
        # 12 granules of 20 B, no dedicated header slot.
        return cls(g_slots=12, h_slots=0, reqs_per_h=0, resps_per_h=0,
                   reqs_per_g=1, resps_per_g=2, data_slots_per_line=4,
                   slot_bits=160)


@dataclasses.dataclass(frozen=True)
class AsymmetricLaneParams(_Stackable):
    """Lane-group geometry for the asymmetric mappings (A/B)."""

    total_lanes: Any
    read_lanes: Any
    write_lanes: Any
    cmd_lanes: Any
    cmd_bits_per_access: Any
    access_bits: Any = 576

    @classmethod
    def lpddr6(cls) -> "AsymmetricLaneParams":
        return cls(total_lanes=74, read_lanes=36, write_lanes=24,
                   cmd_lanes=10, cmd_bits_per_access=96)

    @classmethod
    def hbm(cls) -> "AsymmetricLaneParams":
        return cls(total_lanes=138, read_lanes=72, write_lanes=36,
                   cmd_lanes=24, cmd_bits_per_access=96)


#: every flit-simulator parameter field a perturbation may scale
PERTURBABLE_FIELDS: Tuple[str, ...] = tuple(sorted(
    {f.name for f in dataclasses.fields(SymmetricFlitParams)}
    | {f.name for f in dataclasses.fields(AsymmetricLaneParams)}))


def check_perturbation(pert: Mapping[str, float]) -> None:
    """Reject ``{field: scale}`` perturbations naming unknown fields."""
    unknown = sorted(k for k in pert if k not in PERTURBABLE_FIELDS)
    if unknown:
        raise ValueError(f"unknown perturbation fields {unknown}; choose "
                         f"from {PERTURBABLE_FIELDS}")


# -- single-cycle step functions ----------------------------------------------
#
# Shared by the fixed cores, the escalation grids and the plain versions of
# the kernels (kernels/flit_sim/ref.py).  The CUDA kernels repeat these
# expressions operation for operation, in the same order: every division
# here is tensor by tensor (correctly rounded on both devices) and every
# product with a constant is exact or shared, so the card and the CPU step
# bit for bit alike.


def _symmetric_stepfn(p: SymmetricFlitParams, x, y, backlog):
    """``step(core) -> (core', data_slots_delivered_this_cycle)`` over the
    queue/credit core ``(rq, wq, wdata, rdata, resp, cr, cw)``; all
    operands broadcast against each other."""
    tot = x + y
    xr = x / tot
    yr = y / tot
    dpl = p.data_slots_per_line
    rdata_limit = p.credit_lines * p.g_slots   # in-flight read credit
    wbuf_limit = p.write_buffer_lines * p.g_slots   # write-buffer bound
    h_reqs = p.reqs_per_h * p.h_slots
    h_resps = p.resps_per_h * p.h_slots
    hdr_cap = h_reqs + p.reqs_per_g * p.g_slots
    resp_cap = h_resps + p.resps_per_g * p.g_slots
    reqs_per_g = torch.clamp_min(p.reqs_per_g, 1e-9)
    resps_per_g = torch.clamp_min(p.resps_per_g, 1e-9)

    def step(core):
        rq, wq, wdata, rdata, resp, cr, cw = core
        # -- generate traffic to hold the request backlog at `backlog` ----
        deficit = torch.clamp_min(backlog - (rq + wq), 0.0)
        cr2 = cr + deficit * xr
        cw2 = cw + deficit * yr
        gen_r = torch.floor(cr2)
        gen_w = torch.floor(cw2)
        cr2 = cr2 - gen_r
        cw2 = cw2 - gen_w
        rq = rq + gen_r
        wq = wq + gen_w
        # -- SoC -> Mem flit: headers first, data fills the rest ----------
        credit_r = torch.clamp_min(rdata_limit - rdata, 0.0) / dpl
        credit_w = torch.clamp_min(wbuf_limit - wdata, 0.0) / dpl
        rq_elig = torch.minimum(rq, credit_r)
        wq_elig = torch.minimum(wq, credit_w)
        elig = rq_elig + wq_elig
        sent_req = torch.minimum(elig, hdr_cap)
        tot_q = torch.clamp_min(elig, 1e-9)
        sent_r = sent_req * rq_elig / tot_q
        sent_w = sent_req * wq_elig / tot_q
        g_hdr = torch.clamp_min(sent_req - h_reqs, 0.0) / reqs_per_g
        d_s2m = torch.minimum(wdata, p.g_slots - g_hdr)
        rq = rq - sent_r
        wq = wq - sent_w
        wdata = wdata + sent_w * dpl - d_s2m   # data follows its request
        rdata = rdata + sent_r * dpl
        resp = resp + sent_r + sent_w
        # -- Mem -> SoC flit: responses first, read data fills the rest ---
        sent_resp = torch.minimum(resp, resp_cap)
        g_resp = torch.clamp_min(sent_resp - h_resps, 0.0) / resps_per_g
        d_m2s = torch.minimum(rdata, p.g_slots - g_resp)
        resp = resp - sent_resp
        rdata = rdata - d_m2s
        return (rq, wq, wdata, rdata, resp, cr2, cw2), d_s2m + d_m2s

    return step


def _asymmetric_stepfn(p: AsymmetricLaneParams, x, y):
    """``step(core) -> core'`` over ``(t_read, t_write, t_cmd, credit)``:
    one access; the credit picks read or write."""
    xr = x / (x + y)
    r_ui = p.access_bits / p.read_lanes
    w_ui = p.access_bits / p.write_lanes
    c_ui = p.cmd_bits_per_access / p.cmd_lanes

    def step(core):
        t_read, t_write, t_cmd, credit = core
        credit = credit + xr
        is_read = credit >= 1.0
        credit = torch.where(is_read, credit - 1.0, credit)
        t_read = t_read + torch.where(is_read, r_ui, 0.0)
        t_write = t_write + torch.where(is_read, 0.0, w_ui)
        t_cmd = t_cmd + c_ui
        return (t_read, t_write, t_cmd, credit)

    return step


def _pipelining_stepfn(k, ucie_line_ui, device_line_ui):
    """``step(core) -> core'`` over ``(dev_ready [..., max_k], link_free,
    idx)``: one line issued to device ``idx mod k``, which starts when
    both the device and the link are free.  ``k`` and ``idx`` are integer
    tensors; every operand broadcasts against ``link_free``."""
    def step(core):
        dev_ready, link_free, idx = core
        dev = torch.remainder(idx, k)[..., None]
        start = torch.maximum(dev_ready.gather(-1, dev)[..., 0], link_free)
        finish = start + ucie_line_ui
        dev_ready = dev_ready.scatter(-1, dev,
                                      (start + device_line_ui)[..., None])
        return dev_ready, finish, idx + 1

    return step


def _pipelining_core_init(max_k: int, shape, device):
    """Zero ``(dev_ready, link_free, idx)`` core for cells of ``shape``
    (the ready table padded to ``max_k``: entries past k are never
    addressed)."""
    return (torch.zeros(tuple(shape) + (max_k,), dtype=F32, device=device),
            torch.zeros(tuple(shape), dtype=F32, device=device),
            torch.zeros(tuple(shape), dtype=torch.long, device=device))


def _zeros_like_all(*ts) -> torch.Tensor:
    shape = torch.broadcast_shapes(*[t.shape for t in ts])
    return torch.zeros(shape, dtype=F32, device=ts[0].device)


# -- fixed-horizon cores ------------------------------------------------------


def _symmetric_efficiency(p: SymmetricFlitParams, x, y, backlog,
                          n_flits: int):
    """Saturation data efficiency of a symmetric full-duplex link over the
    fixed horizon ``n_flits``: data bits delivered in the warm window (the
    last three quarters) over both-direction link capacity."""
    step = _symmetric_stepfn(p, x, y, backlog)
    z = _zeros_like_all(x, y, backlog, p.g_slots)
    core = (z,) * 7
    data_slots = z
    w0 = n_flits // 4
    for i in range(n_flits):
        core, new_data = step(core)
        if i + 1 > w0:                  # the warm window
            data_slots = data_slots + new_data
    data_bits = data_slots * 128.0      # 16 B of payload per data slot
    cap_bits = 2.0 * float(n_flits - w0) * p.flit_bits
    return data_bits / cap_bits


def _asymmetric_efficiency(p: AsymmetricLaneParams, x, y, n_accesses: int):
    """Lane-occupancy simulation: issue ``n_accesses`` accesses in x:y
    ratio, measure ``512 n / (total_lanes T)`` — comparable to eq (3)."""
    step = _asymmetric_stepfn(p, x, y)
    z = _zeros_like_all(x, y, p.total_lanes)
    core = (z,) * 4
    for _ in range(n_accesses):
        core = step(core)
    t_r, t_w, t_c, _ = core
    t_total = torch.maximum(torch.maximum(t_r, t_w), t_c)
    return (torch.full_like(t_total, 512.0 * n_accesses)
            / (p.total_lanes * t_total))


def _pipelining_utilization(k, ucie_line_ui, device_line_ui,
                            max_k: int, n_lines: int):
    """Appendix Fig 13: k x12 LPDDR6 devices time-multiplexed behind the
    logic die.  The UCIe link moves a 64 B line in ``ucie_line_ui`` UI;
    each device sources a line every ``device_line_ui`` UI.  Returns link
    data utilization — 1.0 at k = 4.  Commands are pipelined (Fig 13), so
    only device ready times are modelled."""
    step = _pipelining_stepfn(k, ucie_line_ui, device_line_ui)
    shape = torch.broadcast_shapes(k.shape, ucie_line_ui.shape,
                                   device_line_ui.shape)
    core = _pipelining_core_init(max_k, shape, ucie_line_ui.device)
    for _ in range(n_lines):
        core = step(core)
    return n_lines * ucie_line_ui / core[1]


def _symmetric_grid(pstack, x, y, backlogs, *, n_flits: int):
    """[P params] x [B backlogs] x [M mixes] -> efficiency [P, B, M]."""
    p = pstack.map(lambda f: f[:, None, None])
    return _symmetric_efficiency(p, x[None, None, :], y[None, None, :],
                                 backlogs[None, :, None], n_flits)


def _asymmetric_grid(pstack, x, y, *, n_accesses: int):
    """[P params] x [M mixes] -> efficiency [P, M] (backlog-independent)."""
    p = pstack.map(lambda f: f[:, None])
    return _asymmetric_efficiency(p, x[None, :], y[None, :], n_accesses)


def _pipelining_grid(ks, ucie_line_uis, device_line_uis, *, max_k: int,
                     n_lines: int):
    """[K device counts] x [U link UIs] x [D device UIs] -> utilization
    [K, U, D] — the joint faster-DRAM-generations sweep."""
    return _pipelining_utilization(ks[:, None, None],
                                   ucie_line_uis[None, :, None],
                                   device_line_uis[None, None, :],
                                   max_k, n_lines)


def _symmetric_cells_grid(pcells, xs, ys, bs, *, n_flits: int):
    """Flat per-cell fixed-horizon program for exact escalation: each cell
    carries its own (param row, mix, backlog)."""
    return _symmetric_efficiency(pcells, xs, ys, bs, n_flits)


def _asymmetric_cells_grid(pcells, xs, ys, *, n_accesses: int):
    """Flat per-cell fixed-horizon asymmetric program (escalation)."""
    return _asymmetric_efficiency(pcells, xs, ys, n_accesses)


# -- trace-scan cores (the DesignSpace ``trace`` axis) ------------------------
#
# A trace is a sequence of (read_fraction, backlog) phases; the trace-scan
# cores run the phases BACK TO BACK through the shared single-cycle step
# functions, carrying the queue/credit state across every phase boundary —
# a write buffer filled by a prefill burst drains INTO the next decode
# phase instead of being reset.  Every phase runs the same ``cycles``
# count; phase DURATIONS are aggregation weights the design space applies
# on the host.  Accounting resets per phase; phase 0 keeps the fixed
# engine's quarter warm-up (so a SINGLE-phase trace is bitwise equal to
# the fixed static cell) and later phases count every cycle — their
# "warm-up" is the real carried transient.  These are the plain versions
# of the ``symmetric_trace`` / ``asymmetric_trace`` kernels
# (``kernels/flit_sim/ref.py`` calls them on row-stacked cells), in the
# reference's expression order.


def _symmetric_trace_grid(p: SymmetricFlitParams, xs, ys, bls, *,
                          cycles: int) -> torch.Tensor:
    """Per-phase efficiency ``[N, ...]`` of symmetric cells over a phase
    sequence, queue/credit state carried: ``xs`` / ``ys`` / ``bls`` hold
    one tensor per phase, each broadcasting against ``p``'s fields."""
    core, effs = None, []
    for n, (x, y, b) in enumerate(zip(xs, ys, bls)):
        step = _symmetric_stepfn(p, x, y, b)
        if core is None:
            core = (_zeros_like_all(x, y, b, p.g_slots),) * 7
        thresh = cycles // 4 if n == 0 else 0
        data_slots = torch.zeros_like(core[0])
        warm_slots = torch.zeros_like(core[0])
        for warm in range(1, cycles + 1):
            core, new_data = step(core)
            is_warm = 1.0 if warm > thresh else 0.0
            data_slots = data_slots + new_data * is_warm
            warm_slots = warm_slots + is_warm
        data_bits = data_slots * 128.0
        cap_bits = 2.0 * warm_slots * p.flit_bits
        effs.append(data_bits / cap_bits)
    return torch.stack(effs)


def _asymmetric_trace_grid(p: AsymmetricLaneParams, xs, ys, *,
                           cycles: int) -> torch.Tensor:
    """Per-phase efficiency ``[N, ...]`` of asymmetric cells: lane clocks
    and the read/write credit carry across phases; each phase's efficiency
    comes from its lane-time DELTA."""
    core, t_prev, effs = None, None, []
    for x, y in zip(xs, ys):
        step = _asymmetric_stepfn(p, x, y)
        if core is None:
            core = (_zeros_like_all(x, y, p.total_lanes),) * 4
            t_prev = core[0]
        for _ in range(cycles):
            core = step(core)
        t_r, t_w, t_c, _ = core
        t_total = torch.maximum(torch.maximum(t_r, t_w), t_c)
        effs.append(torch.full_like(t_total, 512.0 * cycles)
                    / (p.total_lanes * (t_total - t_prev)))
        t_prev = t_total
    return torch.stack(effs)


# -- adaptive schedule --------------------------------------------------------

#: max pool movement per chunk (slots) still considered "steady"
_DRIFT_TOL_SLOTS = 2.0
#: never exit before this many chunks (two comparable reports + warm-up)
_MIN_EXIT_CHUNKS = 4
#: straggler escalation only pays off on grids at least this large
_ESCALATION_MIN_CELLS = 256
#: max stragglers the early exit may leave behind: cells // this
_ESCALATION_BUDGET_DIV = 8


def _divisor_chunk(horizon: int, chunk: int) -> int:
    """Effective chunk: near ``horizon / 16``, at least the configured
    ``chunk``, at most ``horizon / 8``, snapped down to an exact divisor
    of ``horizon`` (chunk counts that are a multiple of 4 preferred, so
    the reconstructed warm window starts exactly at ``horizon // 4``).
    Returns a value < 8 when ``horizon`` has no usable divisor; the
    runners then fall back to the fixed engine."""
    horizon = int(horizon)
    cap = min(max(int(chunk), horizon // 16), max(horizon // 8, 1))
    best = 1
    for c in range(cap, 7, -1):
        if horizon % c:
            continue
        if (horizon // c) % 4 == 0:
            return c
        best = max(best, c)
    return best


def _escalation_budget(cells: int, chunk: int, horizon: int) -> int:
    """Max stragglers the early exit may strand: roughly where
    re-simulating S cells at the full horizon costs one more full-grid
    chunk, capped at ``cells // _ESCALATION_BUDGET_DIV``."""
    if cells < _ESCALATION_MIN_CELLS:
        return 0
    return min(cells // _ESCALATION_BUDGET_DIV,
               max((cells * chunk) // horizon, 1))


#: telemetry from the most recent adaptive run per engine family
#: (see :func:`last_run_info`)
_LAST_RUN_INFO: Dict[str, Dict[str, Any]] = {}


def last_run_info() -> Dict[str, Dict[str, Any]]:
    """Per-family telemetry of the most recent adaptive run:
    ``cycles_run`` (main-loop chunks executed x chunk),
    ``sequential_depth`` (the horizon whenever an escalation pass ran),
    ``horizon`` / ``chunk`` / ``stragglers`` / ``cells``, ``engine``,
    ``launches`` (kernel launches plus escalation passes),
    ``elapsed_s``, ``cycles_per_sec_per_cell``, and a ``converged_cycles``
    histogram ({cycles: cell count}; stragglers count under
    ``"horizon"``).  Periodic runs add a ``periods`` histogram.  Fixed
    runs do not update it.  Trace-scan runs are kept under
    ``family + ".trace"`` with ``mode="trace"`` (see
    :func:`_record_trace`), streamed evaluations under ``"stream.sim"`` /
    ``"stream.catalog"`` with ``mode="stream"`` (see
    :func:`_record_stream`)."""
    out: Dict[str, Dict[str, Any]] = {}
    for fam, info in _LAST_RUN_INFO.items():
        d = {k: v for k, v in info.items() if not k.startswith("_")}
        if d["mode"] in ("trace", "stream"):
            out[fam] = d
            continue
        chunk = d["chunk"]
        conv_at = np.asarray(info["_conv_at"]).reshape(-1)
        d["cycles_run"] = int(info["_k_exit"]) * chunk
        d["sequential_depth"] = (d["horizon"] if d["stragglers"]
                                 else d["cycles_run"])
        d["cells"] = int(conv_at.size)
        vals, counts = np.unique(conv_at, return_counts=True)
        d["converged_cycles"] = {
            ("horizon" if v < 0 else str(int(v) * chunk)): int(c)
            for v, c in zip(vals, counts)}
        if d.get("elapsed_s"):
            d["cycles_per_sec_per_cell"] = d["cycles_run"] / d["elapsed_s"]
        if info.get("_periods") is not None:
            p = np.asarray(info["_periods"]).reshape(-1)
            pv, pc = np.unique(p[p > 0], return_counts=True)
            d["periods"] = {int(v): int(c) for v, c in zip(pv, pc)}
        out[fam] = d
    return out


def _record_adaptive(family: str, horizon: int, chunk: int, k_exit: int,
                     conv_at: np.ndarray, stragglers: int, *,
                     engine: str, launches: int, elapsed_s: float,
                     periods: Optional[np.ndarray] = None) -> None:
    _LAST_RUN_INFO[family] = {
        "mode": "adaptive", "horizon": int(horizon), "chunk": int(chunk),
        "stragglers": int(stragglers), "engine": engine,
        "launches": int(launches), "elapsed_s": elapsed_s,
        "_k_exit": int(k_exit), "_conv_at": conv_at, "_periods": periods,
    }


def _record_trace(family: str, phases: int, cycles: int, cells: int, *,
                  engine: str, elapsed_s: float) -> None:
    """Telemetry of a trace-scan run, keyed ``family + ".trace"`` so it
    never clobbers the same family's adaptive record: per-phase cycle
    count, total cycles, grid cells simulated, the state-carry depth
    (cycles whose initial state came from a PREVIOUS phase), the engine
    (``"cuda"``: the trace kernel, ``"plain"``: its plain version) and
    the runner's wall seconds (the card's work included)."""
    _LAST_RUN_INFO[family + ".trace"] = {
        "mode": "trace", "phases": int(phases),
        "cycles_per_phase": int(cycles),
        "cycles_run": int(phases) * int(cycles),
        "trace_cells": int(cells),
        "state_carry_depth": (int(phases) - 1) * int(cycles),
        "engine": engine, "elapsed_s": elapsed_s,
    }


def _record_stream(family: str, *, dispatches: int, prefetch: int,
                   pad_cells: int, overlap_frac: float, cells: int,
                   elapsed_s: float, marshal_s: float,
                   shard: Optional[Dict[str, Any]] = None) -> None:
    """Telemetry of a streamed evaluation (``stream.*`` families): the
    dispatch count, the bounded in-flight depth, the replicated tail cells
    over all dispatches, the share of the host's marshalling wall time
    spent while the card still ran an earlier chunk (``overlap_frac``; 0
    on the CPU, where each chunk completes at once), the cells streamed, the wall seconds (the card's work included) and the
    marshalling seconds (``marshal_s / elapsed_s`` bounds what overlap can
    win); in a sharded stream the dispatches, marshal and overlap are
    this rank's own slots and the wall includes the reduction.  ``shard``
    (sharded streams only) adds ``devices``, ``rank``, the wall seconds
    and payload bytes of the end-of-stream reduction (``reduce_s``,
    ``reduce_bytes``) and its ``transport`` (``"device"``: NCCL on the
    card; ``"host"``: gloo in host memory)."""
    _LAST_RUN_INFO[family] = {
        "mode": "stream", "dispatches": int(dispatches),
        "prefetch": int(prefetch), "pad_cells": int(pad_cells),
        "overlap_frac": float(overlap_frac), "cells": int(cells),
        "elapsed_s": elapsed_s, "marshal_s": marshal_s,
        **(shard or {}),
    }


def _gather_cells(pstack, rows: np.ndarray):
    """Per-cell parameter stack: row ``rows[i]`` of every field."""
    first = getattr(pstack, dataclasses.fields(pstack)[0].name)
    idx = torch.as_tensor(rows, device=first.device)
    return pstack.map(lambda f: f[idx])


def _escalate_stragglers(cells_grid_fn, rep: torch.Tensor,
                         conv_np: np.ndarray, args_builder) -> torch.Tensor:
    """Re-simulate unconverged cells EXACTLY at the full fixed horizon in a
    flat per-cell program and scatter the exact values over the adaptive
    reports.  ``args_builder(idx)`` maps the ``[S, ndim]`` straggler
    indices to the flat program's arguments."""
    idx = np.argwhere(~conv_np)
    exact = cells_grid_fn(*args_builder(idx))
    flat = torch.as_tensor(np.flatnonzero(~conv_np), device=rep.device)
    out = rep.reshape(-1).clone()
    out[flat] = exact
    return out.reshape(rep.shape)


def _sym_escalation_args(pstack, x, y, backlogs):
    def build(idx):
        i_b = torch.as_tensor(idx[:, 1], device=x.device)
        i_m = torch.as_tensor(idx[:, 2], device=x.device)
        return (_gather_cells(pstack, idx[:, 0]), x[i_m], y[i_m],
                backlogs[i_b])
    return build


def _asym_escalation_args(pstack, x, y):
    def build(idx):
        i_m = torch.as_tensor(idx[:, 1], device=x.device)
        return _gather_cells(pstack, idx[:, 0]), x[i_m], y[i_m]
    return build


# -- row-stacked kernel operands ----------------------------------------------


def _sym_param_rows(pstack, x, y, backlogs):
    """Row-stack a symmetric grid into the kernels' ``[SYM_ROWS, P*B*M]``
    layout (cell order matches ``rep.reshape(P, B, M)``)."""
    from repro_torch.kernels.flit_sim import ref as fs_ref
    P, B, M = pstack.g_slots.shape[0], backlogs.shape[0], x.shape[0]
    rows = [getattr(pstack, f.name).repeat_interleave(B * M)
            for f in dataclasses.fields(SymmetricFlitParams)]
    rows.append(x.repeat(P * B))
    rows.append(y.repeat(P * B))
    rows.append(backlogs.repeat_interleave(M).repeat(P))
    pad = torch.zeros_like(rows[0])
    return torch.stack(rows + [pad] * (fs_ref.SYM_ROWS - len(rows)))


def _asym_param_rows(pstack, x, y):
    """Row-stack an asymmetric grid into ``[ASYM_ROWS, P*M]``."""
    from repro_torch.kernels.flit_sim import ref as fs_ref
    P, M = pstack.total_lanes.shape[0], x.shape[0]
    rows = [getattr(pstack, f.name).repeat_interleave(M)
            for f in dataclasses.fields(AsymmetricLaneParams)]
    rows.append(x.repeat(P))
    rows.append(y.repeat(P))
    pad = torch.zeros_like(rows[0])
    return torch.stack(rows + [pad] * (fs_ref.ASYM_ROWS - len(rows)))


def _pipe_param_rows(ks, ucie_line_uis, device_line_uis):
    """Row-stack a pipelining grid into ``[PIPE_ROWS, K*U*D]`` (rows 0 k,
    1 ucie_line_ui, 2 device_line_ui; cell order matches
    ``rep.reshape(K, U, D)``)."""
    from repro_torch.kernels.flit_sim import ref as fs_ref
    Kk, U, Dn = (ks.shape[0], ucie_line_uis.shape[0],
                 device_line_uis.shape[0])
    rows = [ks.to(F32).repeat_interleave(U * Dn),
            ucie_line_uis.repeat_interleave(Dn).repeat(Kk),
            device_line_uis.repeat(Kk * U)]
    pad = torch.zeros_like(rows[0])
    return torch.stack(rows + [pad] * (fs_ref.PIPE_ROWS - len(rows)))


def _trace_rows(pstack, n_rows: int, *phase_grids):
    """Row-stack a trace grid for the trace kernels: parameter rows
    ``[n_rows, P*T]`` (the dataclass fields in order, pad rows zero) and,
    per ``[T, N]`` phase grid, its ``[N, P*T]`` rows (cell ``p*T + t``, so
    an output ``[N, P*T]`` reshapes to ``[N, P, T]``)."""
    names = [f.name for f in dataclasses.fields(pstack)]
    first = getattr(pstack, names[0])
    T = phase_grids[0].shape[0]
    rows = [getattr(pstack, n).repeat_interleave(T) for n in names]
    params = torch.zeros((n_rows, first.shape[0] * T), dtype=F32,
                         device=first.device)
    params[:len(rows)] = torch.stack(rows)
    return (params,) + tuple(g.t().repeat(1, first.shape[0])
                             for g in phase_grids)


def _scal_row(values, device) -> torch.Tensor:
    """Broadcast-scalar ``[1, SCAL_COLS]`` operand from leading values."""
    from repro_torch.kernels.flit_sim import ref as fs_ref
    row = np.zeros((1, fs_ref.SCAL_COLS), np.float32)
    row[0, :len(values)] = values
    return torch.as_tensor(row, device=device)


# -- runners ------------------------------------------------------------------


def _run_asymmetric_periodic(pstack, x, y, horizon: int):
    """Period-exact asymmetric run: one ``asymmetric_periodic`` launch plus
    exact escalation of undetected cells.  Returns the report grid, or
    ``None`` when the grid is mostly aperiodic."""
    from repro_torch.kernels.flit_sim import ops as fs_ops
    from repro_torch.kernels.flit_sim import ref as fs_ref
    P, M = pstack.total_lanes.shape[0], x.shape[0]
    cells = P * M
    t0 = time.perf_counter()
    out = fs_ops.asymmetric_periodic(_asym_param_rows(pstack, x, y),
                                     n_accesses=horizon)
    det_np = (out[1] > 0.5).cpu().numpy()
    undet = int((~det_np).sum())
    if undet > max(cells // 4, 8):
        return None
    rep = out[0].reshape(P, M)
    launches = 1
    if undet:
        rep = _escalate_stragglers(
            functools.partial(_asymmetric_cells_grid, n_accesses=horizon),
            rep, det_np.reshape(P, M), _asym_escalation_args(pstack, x, y))
        launches += 1
    periods = out[2].cpu().numpy()
    conv_at = np.where(det_np, 1, -1).astype(np.int32).reshape(P, M)
    _record_adaptive("flitsim.asymmetric", horizon, fs_ref.PERIOD_OBS, 1,
                     conv_at, undet, engine="periodic",
                     launches=launches, elapsed_s=time.perf_counter() - t0,
                     periods=periods)
    return rep


def _run_symmetric_periodic(pstack, x, y, backlogs, horizon: int):
    """Period-exact symmetric run: one ``symmetric_periodic`` launch plus
    exact escalation of undetected cells.  Detection is an EXACT f32
    match of the whole 7-component core against a lagged observation row,
    so detected cells reproduce the fixed engine bit for bit.  Returns
    ``None`` when the grid is mostly aperiodic."""
    from repro_torch.kernels.flit_sim import ops as fs_ops
    from repro_torch.kernels.flit_sim import ref as fs_ref
    P, B, M = pstack.g_slots.shape[0], backlogs.shape[0], x.shape[0]
    cells = P * B * M
    t0 = time.perf_counter()
    out = fs_ops.symmetric_periodic(
        _sym_param_rows(pstack, x, y, backlogs), n_flits=horizon)
    det_np = (out[1] > 0.5).cpu().numpy()
    undet = int((~det_np).sum())
    if undet > max(cells // 4, 8):
        return None
    rep = out[0].reshape(P, B, M)
    launches = 1
    if undet:
        rep = _escalate_stragglers(
            functools.partial(_symmetric_cells_grid, n_flits=horizon),
            rep, det_np.reshape(P, B, M),
            _sym_escalation_args(pstack, x, y, backlogs))
        launches += 1
    periods = out[2].cpu().numpy()
    conv_at = np.where(det_np, 1, -1).astype(np.int32).reshape(P, B, M)
    _record_adaptive("flitsim.symmetric", horizon, fs_ref.SYM_PERIOD_OBS,
                     1, conv_at, undet, engine="periodic",
                     launches=launches, elapsed_s=time.perf_counter() - t0,
                     periods=periods)
    return rep


def _run_symmetric_fused(pstack, x, y, backlogs, horizon: int, chunk: int,
                         sim: SimConfig):
    """Adaptive symmetric run on the fused run kernel (the reference's
    ``_run_symmetric_pallas`` schedule): ONE ``symmetric_run`` launch takes
    every cell chunk after chunk, evaluating report / drift / convergence
    and the early exit on the card; the host reads the flags back once and
    escalates the stragglers."""
    from repro_torch.kernels.flit_sim import ops as fs_ops
    dev = x.device
    P, B, M = pstack.g_slots.shape[0], backlogs.shape[0], x.shape[0]
    cells = P * B * M
    budget = _escalation_budget(cells, chunk, horizon)
    t0 = time.perf_counter()
    state, conv_at, k_exit = fs_ops.symmetric_run(
        _sym_param_rows(pstack, x, y, backlogs), K=horizon // chunk,
        chunk=chunk, tol=sim.tol, budget=budget)
    conv_at, conv_np, k = _read_run(state, conv_at, k_exit)
    rep = state[10].reshape(P, B, M)
    stragglers = int((~conv_np).sum()) if budget > 0 else 0
    launches = 1
    if stragglers:
        rep = _escalate_stragglers(
            functools.partial(_symmetric_cells_grid, n_flits=horizon),
            rep, conv_np.reshape(P, B, M),
            _sym_escalation_args(pstack, x, y, backlogs))
        launches += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _record_adaptive("flitsim.symmetric", horizon, chunk, k,
                     conv_at.reshape(P, B, M), stragglers, engine="fused",
                     launches=launches, elapsed_s=time.perf_counter() - t0)
    return rep


def _read_run(state, conv_at, k_exit):
    """One host read of a run's result: ``(conv_at, the exit chunk's
    flags, k_exit)`` as numpy arrays and an int."""
    cells = conv_at.shape[0]
    host = torch.cat([conv_at, (state[11] > 0.5).to(torch.int32),
                      k_exit]).cpu().numpy()
    return host[:cells], host[cells:2 * cells] > 0, int(host[-1])


def _asymmetric_grid_adaptive(pstack, x, y, *, n_accesses: int, chunk: int,
                              tol: float, budget: int):
    """Chunked early-exit asymmetric core over the ``[P, M]`` grid (plain
    PyTorch; the fallback for mostly aperiodic grids).  The busiest-lane
    time grows linearly in steady state, so the report extrapolates the
    fixed-horizon value from the observed ``T(n)`` plus the trailing
    slope.  Returns ``(report, converged, chunks_run, conv_at)``."""
    P, M = pstack.total_lanes.shape[0], x.shape[0]
    K = n_accesses // chunk
    ch = float(chunk)
    p = pstack.map(lambda f: f[:, None])
    lanes = p.total_lanes
    step = _asymmetric_stepfn(p, x[None, :], y[None, :])
    z = torch.zeros((P, M), dtype=F32, device=x.device)
    core = (z,) * 4
    Th = [z]
    rep = z
    conv = torch.zeros((P, M), dtype=torch.bool, device=x.device)
    conv_at = np.full((P, M), -1, np.int32)
    k, unconv = 0, P * M + budget + 1
    while k < K and unconv > budget:
        for _ in range(chunk):
            core = step(core)
        k += 1
        T = torch.maximum(torch.maximum(core[0], core[1]), core[2])
        Th.append(T)
        ahat = (T - Th[1]) / torch.full_like(T, max((k - 1) * ch, 1.0))
        tail = float(K - k) * ch
        new_rep = (torch.full_like(T, 512.0 * n_accesses)
                   / (lanes * torch.clamp_min(T + ahat * tail, 1e-9)))
        delta = (torch.abs(new_rep - rep)
                 / torch.clamp_min(torch.abs(new_rep), 1e-9))
        conv = ((delta <= tol) & (k >= _MIN_EXIT_CHUNKS)) | (k >= K)
        conv_np = conv.cpu().numpy()
        conv_at[(conv_at < 0) & conv_np] = k
        unconv = int((~conv_np).sum())
        rep = new_rep
    return rep, conv.cpu().numpy(), k, conv_at


def _run_pipelining_fused(ks, ucie_line_uis, device_line_uis,
                          horizon: int, chunk: int, sim: SimConfig):
    """Adaptive pipelining run on the fused run kernel (the reference's
    ``_run_pipelining_pallas`` schedule): ONE ``pipelining_run`` launch,
    the run ending on the card when every cell has converged, one host
    read.  No drift guard or escalation: the rotation report converges
    monotonically."""
    from repro_torch.kernels.flit_sim import ops as fs_ops
    dev = ucie_line_uis.device
    Kk, U, Dn = (ks.shape[0], ucie_line_uis.shape[0],
                 device_line_uis.shape[0])
    t0 = time.perf_counter()
    state, conv_at, k_exit = fs_ops.pipelining_run(
        _pipe_param_rows(ks, ucie_line_uis, device_line_uis),
        K=horizon // chunk, chunk=chunk, tol=sim.tol, n_lines=horizon)
    conv_at, _, k = _read_run(state, conv_at, k_exit)
    rep = state[10].reshape(Kk, U, Dn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _record_adaptive("flitsim.pipelining", horizon, chunk, k,
                     conv_at.reshape(Kk, U, Dn), 0, engine="fused",
                     launches=1, elapsed_s=time.perf_counter() - t0)
    return rep


def _pipelining_grid_adaptive(ks, ucie_line_uis, device_line_uis, *,
                              max_k: int, n_lines: int, chunk: int,
                              tol: float):
    """Chunked early-exit pipelining core over ``[K, U, D]`` in plain
    PyTorch (ready tables wider than the kernel's ``PIPE_MAX_K`` rows).
    The link free time grows linearly once the k-device rotation fills,
    so the report extrapolates it from the first chunk's anchor.  Returns
    ``(report, chunks_run, conv_at)``."""
    dev = ucie_line_uis.device
    shape = (ks.shape[0], ucie_line_uis.shape[0], device_line_uis.shape[0])
    K = n_lines // chunk
    min_k = min(_MIN_EXIT_CHUNKS, K)
    ch = float(chunk)
    ucie = ucie_line_uis[None, :, None]
    step = _pipelining_stepfn(ks[:, None, None], ucie,
                              device_line_uis[None, None, :])
    core = _pipelining_core_init(max_k, shape, dev)
    Th = [core[1]]
    rep = torch.zeros(shape, dtype=F32, device=dev)
    conv_at = np.full(shape, -1, np.int32)
    k, unconv = 0, 1
    while k < K and unconv > 0:
        for _ in range(chunk):
            core = step(core)
        k += 1
        T_k = core[1]
        Th.append(T_k)
        ahat = (T_k - Th[1]) / torch.full_like(T_k, max((k - 1) * ch, 1.0))
        tail = float(K - k) * ch
        new_rep = n_lines * ucie / torch.clamp_min(T_k + ahat * tail, 1e-9)
        delta = (torch.abs(new_rep - rep)
                 / torch.clamp_min(torch.abs(new_rep), 1e-9))
        conv_np = (((delta <= tol) & (k >= min_k)) | (k >= K)).cpu().numpy()
        conv_at[(conv_at < 0) & conv_np] = k
        unconv = int((~conv_np).sum())
        rep = new_rep
    return rep, k, conv_at


def _run_symmetric(pstack, x, y, backlogs, n_flits: int,
                   sim: Optional[SimConfig] = None):
    sim = sim if sim is not None else FIXED_SIM
    if sim.mode == "fixed":
        return _symmetric_grid(pstack, x, y, backlogs, n_flits=n_flits)
    horizon = sim.horizon(n_flits)
    chunk = _divisor_chunk(horizon, sim.chunk)
    if chunk < 8:               # divisor-poor horizon: adaptive degrades
        return _run_symmetric(pstack, x, y, backlogs, horizon,
                              sim=FIXED_SIM)
    from repro_torch.kernels.flit_sim.ref import (
        SYM_PERIOD_OBS, SYM_PERIODIC_MAX_BACKLOG,
    )
    if (horizon // 4 >= SYM_PERIOD_OBS
            and float(backlogs.max()) <= SYM_PERIODIC_MAX_BACKLOG):
        # period-exact cut: observe the pool-state window before the warm
        # window opens and extrapolate bitwise; saturated grids skip the
        # probe (see SYM_PERIODIC_MAX_BACKLOG in kernels/flit_sim/ref.py)
        rep = _run_symmetric_periodic(pstack, x, y, backlogs, horizon)
        if rep is not None:
            return rep
    return _run_symmetric_fused(pstack, x, y, backlogs, horizon, chunk,
                                sim)


def _run_asymmetric(pstack, x, y, n_accesses: int,
                    sim: Optional[SimConfig] = None):
    sim = sim if sim is not None else FIXED_SIM
    P, M = pstack.total_lanes.shape[0], x.shape[0]
    if sim.mode == "fixed":
        return _asymmetric_grid(pstack, x, y, n_accesses=n_accesses)
    horizon = sim.horizon(n_accesses)
    chunk = _divisor_chunk(horizon, sim.chunk)
    if chunk < 8:
        return _run_asymmetric(pstack, x, y, horizon, sim=FIXED_SIM)
    from repro_torch.kernels.flit_sim.ref import PERIOD_OBS
    if horizon >= PERIOD_OBS:
        # period-exact cut: observe ~2 credit periods and extrapolate;
        # falls through to the chunked core on mostly aperiodic grids
        rep = _run_asymmetric_periodic(pstack, x, y, horizon)
        if rep is not None:
            return rep
    t0 = time.perf_counter()
    budget = _escalation_budget(P * M, chunk, horizon)
    rep, conv_np, k_exit, conv_at = _asymmetric_grid_adaptive(
        pstack, x, y, n_accesses=horizon, chunk=chunk, tol=float(sim.tol),
        budget=budget)
    stragglers = 0
    if budget > 0:
        stragglers = int((~conv_np).sum())
        if stragglers:
            rep = _escalate_stragglers(
                functools.partial(_asymmetric_cells_grid,
                                  n_accesses=horizon),
                rep, conv_np, _asym_escalation_args(pstack, x, y))
    _record_adaptive("flitsim.asymmetric", horizon, chunk, k_exit, conv_at,
                     stragglers, engine="torch",
                     launches=1 + (1 if stragglers else 0),
                     elapsed_s=time.perf_counter() - t0)
    return rep


def _run_pipelining(ks, ucie_line_uis, device_line_uis, max_k: int,
                    n_lines: int, sim: Optional[SimConfig] = None):
    sim = sim if sim is not None else FIXED_SIM
    if sim.mode == "fixed":
        return _pipelining_grid(ks, ucie_line_uis, device_line_uis,
                                max_k=max_k, n_lines=n_lines)
    horizon = sim.horizon(n_lines)
    chunk = _divisor_chunk(horizon, sim.chunk)
    if chunk < 8:
        return _run_pipelining(ks, ucie_line_uis, device_line_uis, max_k,
                               horizon, sim=FIXED_SIM)
    from repro_torch.kernels.flit_sim.ref import PIPE_MAX_K
    if max_k <= PIPE_MAX_K:     # the kernel holds PIPE_MAX_K ready rows
        return _run_pipelining_fused(ks, ucie_line_uis, device_line_uis,
                                     horizon, chunk, sim)
    t0 = time.perf_counter()
    rep, k_exit, conv_at = _pipelining_grid_adaptive(
        ks, ucie_line_uis, device_line_uis, max_k=max_k, n_lines=horizon,
        chunk=chunk, tol=float(sim.tol))
    _record_adaptive("flitsim.pipelining", horizon, chunk, k_exit, conv_at,
                     0,                 # exits only converged / at horizon
                     engine="torch", launches=1,
                     elapsed_s=time.perf_counter() - t0)
    return rep


def _run_trace(family: str, pstack, n_rows: int, cycles: int, *grids):
    """Trace-scan runner: ``grids`` are the ``[T, N]`` phase grids of the
    family's kernel (``xs`` / ``ys`` and, symmetric, ``bls``); ONE trace
    kernel launch on the card (its plain version on the CPU) returns
    per-phase efficiency ``[P, T, N]``."""
    from repro_torch.kernels.flit_sim import ops as fs_ops
    first = getattr(pstack, dataclasses.fields(pstack)[0].name)
    P, (T, N), dev = first.shape[0], grids[0].shape, grids[0].device
    t0 = time.perf_counter()
    out = getattr(fs_ops, family + "_trace")(
        *_trace_rows(pstack, n_rows, *grids), cycles=cycles)
    rep = out.reshape(N, P, T).permute(1, 2, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _record_trace("flitsim." + family, N, cycles, P * T,
                  engine="cuda" if dev.type == "cuda" else "plain",
                  elapsed_s=time.perf_counter() - t0)
    return rep


def _run_symmetric_trace(pstack, xs, ys, bls, cycles: int) -> torch.Tensor:
    from repro_torch.kernels.flit_sim.ref import SYM_ROWS
    return _run_trace("symmetric", pstack, SYM_ROWS, cycles, xs, ys, bls)


def _run_asymmetric_trace(pstack, xs, ys, cycles: int) -> torch.Tensor:
    from repro_torch.kernels.flit_sim.ref import ASYM_ROWS
    return _run_trace("asymmetric", pstack, ASYM_ROWS, cycles, xs, ys)


def _run_cells_fixed(sym=None, asym=None, *, n_flits: int,
                     n_accesses: int):
    """Per-cell fixed-horizon runner: ``sym`` is ``(params [SYM_ROWS, C],
    x [1, C], y [1, C], backlog [1, C])`` and ``asym`` ``(params
    [ASYM_ROWS, C'], x [1, C'], y [1, C'])``, each cell its own parameter
    column.  ONE one-phase ``symmetric_trace`` launch (``n_flits``
    cycles) and ONE ``asymmetric_trace`` launch (``n_accesses``) on the
    card — the fixed engine's static cells bit for bit — and their plain
    versions on the CPU.  Returns the ``[C]`` / ``[C']`` efficiencies
    (``None`` for a family not given), enqueued on the current stream
    without a host sync."""
    from repro_torch.kernels.flit_sim import ops as fs_ops
    out_sym = out_asym = None
    if sym is not None:
        out_sym = fs_ops.symmetric_trace(*sym, cycles=int(n_flits))[0]
    if asym is not None:
        out_asym = fs_ops.asymmetric_trace(*asym,
                                           cycles=int(n_accesses))[0]
    return out_sym, out_asym


# -- engine entry point (what DesignSpace lowers onto) ------------------------

#: The five canonical read:write mixes every validation sweep covers.
CANONICAL_MIXES: Tuple[Tuple[float, float], ...] = (
    (1.0, 0.0), (2.0, 1.0), (1.0, 1.0), (1.0, 2.0), (0.0, 1.0))

SYMMETRIC_PARAMS: Dict[str, SymmetricFlitParams] = {
    "cxl_unopt": SymmetricFlitParams.cxl_unopt(),
    "cxl_opt": SymmetricFlitParams.cxl_opt(),
    "chi": SymmetricFlitParams.chi(),
}

ASYMMETRIC_PARAMS: Dict[str, AsymmetricLaneParams] = {
    "lpddr6_asym": AsymmetricLaneParams.lpddr6(),
    "hbm_asym": AsymmetricLaneParams.hbm(),
}

#: every simulated protocol key, in the reference's order
SIMULATED_PROTOCOLS: Tuple[str, ...] = (
    "cxl_unopt", "cxl_opt", "chi", "lpddr6_asym", "hbm_asym")

#: closed-form counterparts of the simulated protocols
ANALYTIC = {
    "cxl_unopt": CXLMemOnUCIe(),
    "cxl_opt": CXLMemOptOnUCIe(),
    "chi": CHIOnUCIe(),
    "lpddr6_asym": LPDDR6OnUCIe(),
    "hbm_asym": HBMOnUCIe(),
}


def _checked(protocols: Sequence[str],
             perturbations: Optional[Sequence[Mapping[str, float]]]):
    """``(keys, perturbation dicts)``, refusing unknown protocol keys and
    perturbations that touch no field of the selected families (which
    would silently label a baseline row as perturbed)."""
    keys = tuple(protocols)
    unknown = sorted(k for k in keys
                     if k not in SYMMETRIC_PARAMS
                     and k not in ASYMMETRIC_PARAMS)
    if unknown:
        raise ValueError(f"unknown protocol keys {unknown}; "
                         f"choose from {sorted(SIMULATED_PROTOCOLS)}")
    perts = [dict(p) for p in (perturbations or [{}])]
    active_fields: set = set()
    if any(k in SYMMETRIC_PARAMS for k in keys):
        active_fields |= {f.name
                          for f in dataclasses.fields(SymmetricFlitParams)}
    if any(k in ASYMMETRIC_PARAMS for k in keys):
        active_fields |= {f.name
                          for f in dataclasses.fields(AsymmetricLaneParams)}
    for p in perts:
        check_perturbation(p)
        if p and not set(p) & active_fields:
            raise ValueError(
                f"perturbation {p} applies to no parameter of the selected "
                f"protocols {keys}; applicable fields: "
                f"{sorted(active_fields)}")
    return keys, perts


def simulate_grid(protocols: Sequence[str], x, y, backlogs, *,
                  perturbations: Optional[Sequence[Mapping[str, float]]]
                  = None,
                  n_flits: int = 2048,
                  n_accesses: int = 4096,
                  sim: Optional[SimConfig] = None,
                  device=None) -> torch.Tensor:
    """Evaluate the full ``[Q perturbations, P protocols, B backlogs,
    M mixes]`` grid, one engine run per simulator family.

    ``x`` / ``y`` are flat ``[M]`` mix arrays; ``backlogs`` is ``[B]``
    (symmetric family only — asymmetric rows broadcast across it).
    ``perturbations`` are multiplicative ``{field: scale}`` overrides
    folded into the parameter stacks.  Returns efficiency ``[Q, P, B, M]``
    on ``device``."""
    dev = device_mod.resolve(device)
    keys, perts = _checked(protocols, perturbations)
    x = _f32(np.asarray(x).reshape(-1), dev)
    y = _f32(np.asarray(y).reshape(-1), dev)
    b = _f32(np.asarray(backlogs).reshape(-1), dev)
    n_q, n_b, n_m = len(perts), b.shape[0], x.shape[0]

    per_key: Dict[str, torch.Tensor] = {}            # key -> [Q, B, M]
    sym_keys = [k for k in keys if k in SYMMETRIC_PARAMS]
    if sym_keys:
        pstack = SymmetricFlitParams.stack(
            [SYMMETRIC_PARAMS[k].perturbed(p) for p in perts
             for k in sym_keys], dev)
        grid = _run_symmetric(pstack, x, y, b, int(n_flits), sim=sim)
        grid = grid.reshape((n_q, len(sym_keys), n_b, n_m))
        for i, k in enumerate(sym_keys):
            per_key[k] = grid[:, i]
    asym_keys = [k for k in keys if k in ASYMMETRIC_PARAMS]
    if asym_keys:
        pstack = AsymmetricLaneParams.stack(
            [ASYMMETRIC_PARAMS[k].perturbed(p) for p in perts
             for k in asym_keys], dev)
        grid = _run_asymmetric(pstack, x, y, int(n_accesses), sim=sim)
        grid = grid.reshape((n_q, len(asym_keys), n_m))
        for i, k in enumerate(asym_keys):
            per_key[k] = grid[:, i, None, :].expand(n_q, n_b, n_m)
    return torch.stack([per_key[k] for k in keys], dim=1)   # [Q, P, B, M]


def simulate_trace_grid(protocols: Sequence[str], xs, ys, backlogs, *,
                        perturbations: Optional[
                            Sequence[Mapping[str, float]]] = None,
                        n_flits: int = 2048, n_accesses: int = 4096,
                        sim: Optional[SimConfig] = None,
                        device=None) -> torch.Tensor:
    """Evaluate ``T`` traffic traces of ``N`` phases each through the
    trace-scan cores: per-PHASE efficiency ``[Q, P, T, N]`` on ``device``.

    ``xs`` / ``ys`` / ``backlogs`` are ``[T, N]`` phase grids (read / write
    mix percentages and queue backlog per phase).  Queue and credit state
    carries across phase boundaries inside each (protocol, trace) cell, so
    phase ``n``'s efficiency includes the transient inherited from phase
    ``n-1``; a single-phase trace is bitwise equal to the fixed static
    cell at the same (mix, backlog).  Asymmetric protocols ignore the
    backlog grid, exactly as in :func:`simulate_grid`.  Every phase runs
    ``sim.trace_cycles`` cycles (default: the family's static horizon —
    ``n_flits`` symmetric, ``n_accesses`` asymmetric) whatever ``sim``'s
    mode.  Phase DURATIONS are not consumed here: the design space applies
    them as aggregation weights over the returned per-phase grid."""
    dev = device_mod.resolve(device)
    sim = sim if sim is not None else FIXED_SIM
    keys, perts = _checked(protocols, perturbations)
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.float32)
    bls = np.asarray(backlogs, np.float32)
    if xs.ndim != 2 or xs.shape != ys.shape or xs.shape != bls.shape:
        raise ValueError(
            f"trace phase grids must share one [T, N] shape; got "
            f"xs {xs.shape}, ys {ys.shape}, backlogs {bls.shape}")
    n_q, (n_t, n_p) = len(perts), xs.shape
    xs, ys, bls = _f32(xs, dev), _f32(ys, dev), _f32(bls, dev)

    per_key: Dict[str, torch.Tensor] = {}            # key -> [Q, T, N]
    sym_keys = [k for k in keys if k in SYMMETRIC_PARAMS]
    if sym_keys:
        pstack = SymmetricFlitParams.stack(
            [SYMMETRIC_PARAMS[k].perturbed(p) for p in perts
             for k in sym_keys], dev)
        grid = _run_symmetric_trace(pstack, xs, ys, bls,
                                    int(sim.trace_cycles or n_flits))
        grid = grid.reshape((n_q, len(sym_keys), n_t, n_p))
        for i, k in enumerate(sym_keys):
            per_key[k] = grid[:, i]
    asym_keys = [k for k in keys if k in ASYMMETRIC_PARAMS]
    if asym_keys:
        pstack = AsymmetricLaneParams.stack(
            [ASYMMETRIC_PARAMS[k].perturbed(p) for p in perts
             for k in asym_keys], dev)
        grid = _run_asymmetric_trace(pstack, xs, ys,
                                     int(sim.trace_cycles or n_accesses))
        grid = grid.reshape((n_q, len(asym_keys), n_t, n_p))
        for i, k in enumerate(asym_keys):
            per_key[k] = grid[:, i]
    return torch.stack([per_key[k] for k in keys], dim=1)   # [Q, P, T, N]


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """``efficiency`` is ``[P, M]`` for a single backlog and ``[P, B, M]``
    for a backlog grid; axes follow ``protocols`` / ``backlogs`` /
    ``mixes`` order."""

    protocols: Tuple[str, ...]
    mixes: Tuple[Tuple[float, float], ...]
    backlogs: Optional[Tuple[float, ...]]
    efficiency: torch.Tensor


def _normalize_mixes(mixes) -> Tuple[Tuple[float, float], ...]:
    if mixes is None:
        return CANONICAL_MIXES
    out = []
    for m in mixes:
        if hasattr(m, "x") and hasattr(m, "y"):     # TrafficMix
            x, y = float(m.x), float(m.y)
        else:
            x, y = m
            x, y = float(x), float(y)
        _check_mix(x, y)
        out.append((x, y))
    return tuple(out)


def _sweep_impl(protocols: Optional[Sequence[str]] = None,
                mixes=None,
                backlogs: Union[None, float, Sequence[float]] = None,
                *, n_flits: int = 2048, n_accesses: int = 4096,
                sim: Optional[SimConfig] = None,
                device=None) -> SweepResult:
    """Protocols x mixes (x backlogs) sweep — the engine body behind the
    knee extraction and the fixed-engine goldens."""
    keys = tuple(protocols) if protocols is not None \
        else SIMULATED_PROTOCOLS
    if not keys:
        raise ValueError("sweep needs at least one protocol key")
    mix_tuples = _normalize_mixes(mixes)
    if not mix_tuples:
        raise ValueError("sweep needs at least one traffic mix")
    squeeze_b = backlogs is None or np.ndim(backlogs) == 0
    if backlogs is None:
        backlog_vals: Tuple[float, ...] = (64.0,)
    else:
        backlog_vals = tuple(
            float(b) for b in np.atleast_1d(np.asarray(backlogs)))
    eff = simulate_grid(keys, [m[0] for m in mix_tuples],
                        [m[1] for m in mix_tuples], backlog_vals,
                        n_flits=n_flits, n_accesses=n_accesses, sim=sim,
                        device=device)[0]                   # [P, B, M]
    if squeeze_b:
        return SweepResult(protocols=keys, mixes=mix_tuples, backlogs=None,
                           efficiency=eff[:, 0, :])
    return SweepResult(protocols=keys, mixes=mix_tuples,
                       backlogs=backlog_vals, efficiency=eff)


def sweep_perturbed(perturbations: Sequence[Mapping[str, float]],
                    protocols: Optional[Sequence[str]] = None,
                    mixes=None,
                    backlogs: Union[None, float, Sequence[float]] = None,
                    *, n_flits: int = 2048, n_accesses: int = 4096,
                    sim: Optional[SimConfig] = None, device=None):
    """Protocol-parameter sensitivity sweep: multiplicative ``{field:
    scale}`` perturbations (slot counts, credit limits, lane splits) of
    the parameter stacks, run perturbation-major through the fixed engine
    or, under ``ADAPTIVE_SIM``, the adaptive kernels.

    Front end over the axes-first API: returns a
    :class:`repro_torch.core.space.SpaceResult` whose ``sim_efficiency``
    array carries a ``protocol_param`` axis — put ``{}`` first to get the
    baseline row."""
    from repro_torch.core.space import DesignSpace, axis
    keys = tuple(protocols) if protocols is not None \
        else SIMULATED_PROTOCOLS
    axes = [axis("protocol_param", list(perturbations)),
            axis("protocol", keys),
            axis("mix", _normalize_mixes(mixes))]
    if backlogs is not None and np.ndim(backlogs) > 0:
        axes.append(axis("backlog", list(np.atleast_1d(backlogs))))
        default_backlog = 64.0
    else:
        default_backlog = 64.0 if backlogs is None else float(backlogs)
    return DesignSpace(axes, default_backlog=default_backlog,
                       n_flits=n_flits, n_accesses=n_accesses, sim=sim,
                       device=device).evaluate(metrics=("sim_efficiency",))


# -- scalar entry points (thin wrappers over a [1, 1, 1] grid) ----------------


def simulate_symmetric(params: SymmetricFlitParams, x: float, y: float,
                       n_flits: int = 2048, backlog: float = 64, *,
                       device=None) -> float:
    """Single-point symmetric simulation (fixed engine)."""
    _check_mix(x, y)
    dev = device_mod.resolve(device)
    pstack = SymmetricFlitParams.stack([params], dev)
    eff = _run_symmetric(pstack, _f32([x], dev), _f32([y], dev),
                         _f32([backlog], dev), int(n_flits))
    return float(eff[0, 0, 0])


def simulate_asymmetric(params: AsymmetricLaneParams, x: float, y: float,
                        n_accesses: int = 4096, *, device=None) -> float:
    """Single-point asymmetric simulation (fixed engine)."""
    _check_mix(x, y)
    dev = device_mod.resolve(device)
    pstack = AsymmetricLaneParams.stack([params], dev)
    eff = _run_asymmetric(pstack, _f32([x], dev), _f32([y], dev),
                          int(n_accesses))
    return float(eff[0, 0])


#: ready-table width every k <= 8 shares (the kernel's PIPE_MAX_K rows)
_PIPELINING_PAD_K = 8


def _ks(ks, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ks, np.int64).reshape(-1),
                           device=device)


def simulate_lpddr6_pipelining(num_devices: int, n_lines: int = 512,
                               ucie_line_ui: float = 16,
                               device_line_ui: float = 64, *,
                               device=None) -> float:
    """Single-k Fig-13 pipelining simulation (fixed engine)."""
    dev = device_mod.resolve(device)
    max_k = max(int(num_devices), _PIPELINING_PAD_K)
    u = _run_pipelining(_ks([num_devices], dev), _f32([ucie_line_ui], dev),
                        _f32([device_line_ui], dev), max_k, int(n_lines))
    return float(u[0, 0, 0])


def _sweep_pipelining_impl(ks: Sequence[int], n_lines: int = 512,
                           ucie_line_ui: Union[float, Sequence[float]] = 16,
                           device_line_ui: Union[float, Sequence[float]] = 64,
                           sim: Optional[SimConfig] = None,
                           device=None) -> torch.Tensor:
    """Engine body of the ``k`` / ``ucie_line_ui`` / ``device_line_ui``
    design-space axes: utilization ``[K, U, D]`` (``[K]`` when both UI
    arguments are scalars)."""
    dev = device_mod.resolve(device)
    ks = tuple(int(k) for k in ks)
    squeeze = (np.ndim(ucie_line_ui) == 0 and np.ndim(device_line_ui) == 0)
    us = _f32(np.atleast_1d(np.asarray(ucie_line_ui, dtype=np.float64)),
              dev)
    ds = _f32(np.atleast_1d(np.asarray(device_line_ui, dtype=np.float64)),
              dev)
    max_k = max(max(ks), _PIPELINING_PAD_K)
    util = _run_pipelining(_ks(ks, dev), us, ds, max_k, int(n_lines),
                           sim=sim)
    return util[:, 0, 0] if squeeze else util


#: Default queue-depth axis for knee extraction.
KNEE_BACKLOGS: Tuple[float, ...] = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                                    128.0)


def backlog_knees(mixes=None,
                  backlogs: Sequence[float] = KNEE_BACKLOGS,
                  knee_frac: float = 0.95,
                  n_flits: int = 2048,
                  per_mix: bool = False,
                  sim: Optional[SimConfig] = None,
                  device=None) -> Dict[str, Any]:
    """Efficiency-cliff knee per simulated protocol: the smallest backlog
    at which simulated efficiency reaches ``knee_frac`` of the protocol's
    best over the backlog axis (maximized over ``mixes`` unless
    ``per_mix``)."""
    res = _sweep_impl(mixes=mixes, backlogs=backlogs, n_flits=n_flits,
                      sim=sim, device=device)
    eff = res.efficiency.cpu().numpy()                  # [P, B, M]
    b = np.asarray(res.backlogs, dtype=np.float64)
    knees: Dict[str, Any] = {}
    for i, key in enumerate(res.protocols):
        e = eff[i]
        ok = e >= knee_frac * e.max(axis=0, keepdims=True)
        first = np.argmax(ok, axis=0)
        knees[key] = b[first] if per_mix else float(b[first].max())
    return knees


#: scalar simulator per protocol key: ``SIMULATORS[key](x, y,
#: device=None) -> efficiency`` (fixed engine)
SIMULATORS = {
    "cxl_unopt": lambda x, y, device=None: simulate_symmetric(
        SymmetricFlitParams.cxl_unopt(), x, y, device=device),
    "cxl_opt": lambda x, y, device=None: simulate_symmetric(
        SymmetricFlitParams.cxl_opt(), x, y, device=device),
    "chi": lambda x, y, device=None: simulate_symmetric(
        SymmetricFlitParams.chi(), x, y, device=device),
    "lpddr6_asym": lambda x, y, device=None: simulate_asymmetric(
        AsymmetricLaneParams.lpddr6(), x, y, device=device),
    "hbm_asym": lambda x, y, device=None: simulate_asymmetric(
        AsymmetricLaneParams.hbm(), x, y, device=device),
}
