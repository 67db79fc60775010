"""Plain PyTorch versions of the fused flit-simulator kernels.

Port of :mod:`repro.kernels.flit_sim.ref`.  Each function here is the
plain version of one CUDA kernel in ``repro_torch/csrc/flit_sim.cu``: the
kernel repeats its arithmetic operation for operation, in the same
order, so the two agree bit for bit on the card (``chip_smoke.py`` holds
them to ``torch.equal``).  The launch wrappers in
:mod:`repro_torch.kernels.flit_sim.ops` run these on CPU tensors.

To stay bitwise across devices every division is tensor by tensor
(PyTorch's CUDA division by a host scalar multiplies by a reciprocal),
a constant divisor that is not a power of two is written as a product
with its reciprocal, and a first-true search takes the smallest index.

Every contract works on ROW-STACKED f32 tensors ``[rows, cells]`` (cells
last, so neighbouring threads read neighbouring addresses).  Row layouts:

symmetric ``params`` [16, C] (pad rows zero)::

    0..10  SymmetricFlitParams fields in dataclass order
    11 x   12 y   13 backlog

symmetric ``state`` [16, C] — also the chunk output layout::

    0..6   core (rq, wq, wdata, rdata, resp, cr, cw)
    7 D    cumulative data slots        8 TD   time-weighted sum(t * d_t)
    9 t    cycles simulated             10 rep  last report
    11 conv  convergence flag (output only)

symmetric ``hist`` [16, C] — chunk-boundary rows the host gathers::

    0..4   pools (rq, wq, wdata, rdata, resp) at chunk max(k-3, 0)
    5 D_m  6 TD_m  7 D_mid  8 TD_mid   (zeros when m == k / mid == k:
           the fresh accumulators are used instead)
    9 D_K0 (zeros when k <= K0)

symmetric ``scal`` [1, 128] broadcast scalars::

    0 k  1 m  2 mid  3 K0  4 K  5 chunk  6 tol
    7 exit_ok (k >= min_k and k > drift span)   8 at_horizon (k == K)
    9 drift_tol (slots / chunk)

asymmetric ``params`` [8, C]: AsymmetricLaneParams fields in dataclass
order then 6 x, 7 y.  Output [8, C]: 0 rep, 1 detected, 2 period.

pipelining ``params`` [16, C] (pad rows zero)::

    0 k (devices)   1 ucie_line_ui   2 device_line_ui

pipelining ``state`` [16, C] — also the chunk output layout::

    0..7   device ready table (rows past k never addressed)
    8 link_free   9 idx (lines issued)   10 rep   11 conv (output only)

pipelining ``hist`` [8, C]: row 0 the link free time after chunk 1 (the
T1 anchor of the linear-growth extrapolation; unused at chunk 1).

pipelining ``scal`` [1, 128]::

    0 k  1 K  2 chunk  3 tol  4 exit_ok (k >= min_k)  5 at_horizon
    6 n_lines (the horizon)

symmetric periodic: input is the symmetric ``params`` [16, C] stack;
output [8, C]: 0 rep, 1 detected, 2 period (pad rows zero).

A whole adaptive run (``symmetric_run_compute``,
``pipelining_run_compute``) takes only ``params`` and returns the state
rows after its exit chunk, each cell's first converged chunk ``conv_at``
([C] int32, -1 for none) and the exit chunk ``k_exit`` ([1] int32).

trace scans (``symmetric_trace_compute``, ``asymmetric_trace_compute``;
port kernels with no TPU counterpart: the reference runs them as XLA
scans): ``params`` [SYM_ROWS, C] (rows 0..10 the SymmetricFlitParams
fields, pad rows zero) or [ASYM_ROWS, C] (rows 0..5 the
AsymmetricLaneParams fields), the per-phase rows ``xs``, ``ys`` and
(symmetric) ``bls`` [N, C], one row per phase; output [N, C], one
efficiency row per phase.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flitsim import (
    _DRIFT_TOL_SLOTS, _MIN_EXIT_CHUNKS, AsymmetricLaneParams,
    SymmetricFlitParams, _asymmetric_stepfn, _asymmetric_trace_grid,
    _scal_row, _symmetric_stepfn, _symmetric_trace_grid,
)

#: rows per stacked operand
SYM_ROWS = 16
ASYM_ROWS = 8
PIPE_ROWS = 16
#: broadcast-scalar operand shape (one row)
SCAL_COLS = 128

#: largest period the detectors resolve; the observation run is ~2 such
#: periods (warm prefix + one full window)
PERIOD_MAX = 64
PERIOD_WINDOW = PERIOD_MAX + 1
PERIOD_WARM = PERIOD_MAX - 1
#: sequential steps the periodic observers execute
PERIOD_OBS = PERIOD_WARM + PERIOD_WINDOW
#: credit-phase match tolerance — true-period matches differ only by f32
#: accumulation noise while non-matches differ by >= 1/PERIOD_MAX
PERIOD_EPS = 1e-4

#: symmetric periodic detector: same geometry, EXACT f32 state match
SYM_PERIOD_OBS = PERIOD_WARM + PERIOD_WINDOW
#: output rows of the symmetric periodic contract
SYM_PERIODIC_ROWS = 8
#: probe gate: grids whose max backlog exceeds this skip the symmetric
#: periodic probe (saturated pools re-round the read/write split every
#: cycle, so their state period always exceeds PERIOD_MAX)
SYM_PERIODIC_MAX_BACKLOG = 4.0

#: device-ready table width shared with flitsim._PIPELINING_PAD_K
PIPE_MAX_K = 8

#: drift-guard pool-snapshot span, in chunks
DRIFT_SPAN = 3.0


def _first_true(ok: torch.Tensor):
    """(any, smallest true row index) per column of a ``[R, C]`` mask;
    the index is 0 where no row is true (``argmax`` of all-false)."""
    rows = torch.arange(ok.shape[0], device=ok.device)[:, None]
    found = ok.any(dim=0)
    first = torch.where(ok, rows, ok.shape[0]).amin(dim=0)
    return found, torch.where(found, first, 0)


def symmetric_chunk_compute(params, state, hist, scal, *, chunk: int):
    """Advance every cell ``chunk`` cycles and re-evaluate report + drift
    + convergence — one launch worth of the adaptive symmetric loop."""
    p = SymmetricFlitParams(*[params[i] for i in range(11)])
    x, y, backlog = params[11], params[12], params[13]
    step = _symmetric_stepfn(p, x, y, backlog)
    core = tuple(state[i] for i in range(7))
    D, TD, t = state[7], state[8], state[9]
    rep_prev = state[10]
    for _ in range(chunk):
        core, nd = step(core)
        t = t + 1.0
        D = D + nd
        TD = TD + t * nd

    kf, mf, midf = scal[0, 0], scal[0, 1], scal[0, 2]
    K0f, Kf, ch = scal[0, 3], scal[0, 4], scal[0, 5]
    tol, exit_ok = scal[0, 6], scal[0, 7]
    at_hor, drift_tol = scal[0, 8], scal[0, 9]

    # report: triangular trailing-window mean blended with the observed
    # warm prefix (chunk indices are small ints, exact in f32)
    denom = 2.0 * params[8] / 128.0
    D_m = torch.where(mf == kf, D, hist[5])
    TD_m = torch.where(mf == kf, TD, hist[6])
    D_mid = torch.where(midf == kf, D, hist[7])
    TD_mid = torch.where(midf == kf, TD, hist[8])
    b_i, b_m, b_j = mf * ch, midf * ch, kf * ch
    c1, c2 = b_m - b_i, b_j - b_m
    w_sum = c1 * (c1 + 1.0) / 2.0 + c2 * (c2 - 1.0) / 2.0
    num = ((TD_mid - TD_m) - b_i * (D_mid - D_m)
           + b_j * (D - D_mid) - (TD - TD_mid))
    mu = num / (torch.clamp_min(w_sum, 1.0) * denom)
    wA = torch.clamp_min(kf - K0f, 1.0) * ch
    A = (D - hist[9]) / (wA * denom)
    rep = torch.where(kf > K0f,
                      (A * (kf - K0f) + mu * (Kf - kf)) / (Kf - K0f), mu)

    pools = torch.stack(core[:5])
    drift = (torch.abs(pools - hist[0:5]).amax(dim=0)
             * (1.0 / DRIFT_SPAN))
    delta = torch.abs(rep - rep_prev) / torch.clamp_min(torch.abs(rep),
                                                        1e-9)
    conv = (((delta <= tol) & (drift < drift_tol) & (exit_ok > 0.0))
            | (at_hor > 0.0)).to(torch.float32)

    pad = torch.zeros_like(D)
    return torch.stack(list(core) + [D, TD, t, rep, conv]
                       + [pad] * (SYM_ROWS - 12))


def symmetric_run_compute(params, *, K: int, chunk: int, tol: float,
                          budget: int):
    """A whole adaptive symmetric run, the host loop of the reference's
    ``_run_symmetric_pallas``: one :func:`symmetric_chunk_compute` a chunk,
    the host gathering each chunk's history rows (a list of chunk-boundary
    rows) and scalar row and reading the flag row back after it, until at
    most ``budget`` cells are unconverged or the horizon chunk ``K``.
    Returns ``(state, conv_at, k_exit)``."""
    dev = params.device
    cells = params.shape[1]
    K0 = max(K // 4, 1)
    min_k = max(_MIN_EXIT_CHUNKS, K0 + 1)
    span = int(DRIFT_SPAN)
    state = torch.zeros((SYM_ROWS, cells), dtype=torch.float32, device=dev)
    zrow = torch.zeros((1, cells), dtype=torch.float32, device=dev)
    z5 = torch.zeros((5, cells), dtype=torch.float32, device=dev)
    z6 = torch.zeros((6, cells), dtype=torch.float32, device=dev)
    Dh, TDh, Ph = [zrow], [zrow], [z5]

    def hist_for(k: int):
        m = max(k - 4, (k + 1) // 2)
        mid = (m + k + 1) // 2
        return m, mid, torch.cat([
            Ph[max(k - span, 0)],
            Dh[m] if m < k else zrow, TDh[m] if m < k else zrow,
            Dh[mid] if mid < k else zrow, TDh[mid] if mid < k else zrow,
            Dh[K0] if k > K0 else zrow, z6])

    def scal_for(k: int, m: int, mid: int):
        return _scal_row([k, m, mid, K0, K, chunk, tol,
                          1.0 if (k >= min_k and k > span) else 0.0,
                          1.0 if k >= K else 0.0, _DRIFT_TOL_SLOTS], dev)

    conv_at = np.full(cells, -1, np.int32)
    k = 0
    while k < K:
        k += 1
        m, mid, hist = hist_for(k)
        state = symmetric_chunk_compute(params, state, hist,
                                        scal_for(k, m, mid), chunk=chunk)
        Dh.append(state[7:8])
        TDh.append(state[8:9])
        Ph.append(state[0:5])
        conv_np = (state[11] > 0.5).cpu().numpy()
        conv_at[(conv_at < 0) & conv_np] = k
        if int((~conv_np).sum()) <= budget:
            break
    return (state, torch.as_tensor(conv_at, device=dev),
            torch.tensor([k], dtype=torch.int32, device=dev))


def asymmetric_periodic_compute(params, *, n_accesses: int):
    """One-launch period-exact asymmetric evaluation.

    Runs the PERIOD_OBS-step observation (warm prefix, then a
    PERIOD_WINDOW ring of per-step lane/credit values), detects each
    cell's credit period d <= PERIOD_MAX from the credit phase, and
    extrapolates every lane's busy time exactly to the horizon::

        T_lane(N) = T(n0) + m * [T(n0) - T(n0 - d)]
                  + [T(n0 - d + r) - T(n0 - d)]        N - n0 = m*d + r

    Undetected cells are flagged for exact escalation by the caller."""
    W = PERIOD_WINDOW
    p = AsymmetricLaneParams(*[params[i] for i in range(6)])
    x, y = params[6], params[7]
    step = _asymmetric_stepfn(p, x, y)
    core = tuple(torch.zeros_like(x) for _ in range(4))
    for _ in range(PERIOD_WARM):
        core = step(core)
    window = []
    for _ in range(W):
        core = step(core)
        window.append(torch.stack(core))
    tr, tw, tc, cr = torch.stack(window, dim=1)          # each [W, C]

    # smallest lag d with matching credit phase (row j <-> d = j + 1)
    lag = cr[W - 1 - PERIOD_MAX:W - 1].flip(0)
    ok = torch.abs(cr[W - 1][None, :] - lag) < PERIOD_EPS
    detected, j = _first_true(ok)
    d = j + 1

    rem = n_accesses - PERIOD_OBS
    m = torch.div(rem, d, rounding_mode="floor")
    r = rem - m * d
    ia = (W - 1 - d)[None, :]
    ib = (W - 1 - d + r)[None, :]
    mf = m.to(torch.float32)

    def lane(t):
        t_cur = t[W - 1]
        t_a = t.gather(0, ia)[0]                          # T(n0 - d)
        t_b = t.gather(0, ib)[0]                          # T(n0 - d + r)
        return t_cur + mf * (t_cur - t_a) + (t_b - t_a)

    T = torch.maximum(torch.maximum(lane(tr), lane(tw)), lane(tc))
    rep = (torch.full_like(T, 512.0 * n_accesses)
           / (params[0] * torch.clamp_min(T, 1e-9)))
    rep = torch.where(detected, rep, 0.0)
    period = torch.where(detected, d, 0).to(torch.float32)
    pad = torch.zeros_like(rep)
    return torch.stack([rep, detected.to(torch.float32), period]
                       + [pad] * (ASYM_ROWS - 3))


def symmetric_periodic_compute(params, *, n_flits: int):
    """One-launch period-exact symmetric evaluation.

    Runs the SYM_PERIOD_OBS-cycle observation (warm prefix, then a
    PERIOD_WINDOW ring of per-cycle core states and deliveries), detects
    each cell's pool-state period by EXACT f32 equality of the whole
    7-component core against the lagged rows, and extrapolates the
    warm-window delivery sum in closed form::

        S(W0..N) = g(N - n0) - g(W0 - n0)
        g(M)     = (M // d) * P + C[M mod d]          n0 = SYM_PERIOD_OBS

    where ``P`` is the delivery sum over the last detected period and
    ``C`` its prefix sums.  A state match is a trajectory certificate and
    the detector requires the last d deliveries to be integers, so every
    sum is exact and the report equals the fixed engine's bit for bit.
    Callers keep ``n_flits // 4 >= SYM_PERIOD_OBS``."""
    W = PERIOD_WINDOW
    p = SymmetricFlitParams(*[params[i] for i in range(11)])
    x, y, backlog = params[11], params[12], params[13]
    step = _symmetric_stepfn(p, x, y, backlog)
    core = tuple(torch.zeros_like(x) for _ in range(7))
    for _ in range(PERIOD_WARM):
        core, _ = step(core)
    window = []
    for _ in range(W):
        core, nd = step(core)
        window.append(torch.stack(core + (nd,)))
    win = torch.stack(window, dim=1)                      # [8, W, C]
    dwin = win[7]

    # smallest lag d whose full core matches EXACTLY, with the last d
    # deliveries integer-valued (so every f32 partial sum is exact)
    lag = win[:7, W - 1 - PERIOD_MAX:W - 1].flip(1)
    ok = (win[:7, W - 1][:, None, :] == lag).all(dim=0)   # [64, C]
    is_int = (torch.floor(dwin) == dwin).to(torch.int32)
    suffix = torch.cumsum(is_int.flip(0), dim=0)          # rows from end
    need = torch.arange(1, PERIOD_MAX + 1, device=params.device)[:, None]
    ok = ok & (suffix[:PERIOD_MAX] == need)
    detected, j = _first_true(ok)
    d = j + 1

    rows = torch.arange(W, device=params.device)[:, None]
    in_period = rows >= (W - d)[None, :]                  # last d rows
    psum = torch.where(in_period, dwin, 0.0).sum(dim=0)

    def g(M):                                             # M >= 0
        m = torch.div(M, d, rounding_mode="floor")
        r = M - m * d
        pref = in_period & (rows < (W - d + r)[None, :])
        return (m.to(torch.float32) * psum
                + torch.where(pref, dwin, 0.0).sum(dim=0))

    W0 = n_flits // 4
    S = g(n_flits - SYM_PERIOD_OBS) - g(W0 - SYM_PERIOD_OBS)
    # same expression order as flitsim._symmetric_efficiency
    data_bits = S * 128.0
    cap_bits = 2.0 * float(n_flits - W0) * p.flit_bits
    rep = torch.where(detected, data_bits / cap_bits, 0.0)
    period = torch.where(detected, d, 0).to(torch.float32)
    pad = torch.zeros_like(rep)
    return torch.stack([rep, detected.to(torch.float32), period]
                       + [pad] * (SYM_PERIODIC_ROWS - 3))


def pipelining_chunk_compute(params, state, hist, scal, *, chunk: int):
    """Per-chunk body of the adaptive Fig-13 pipelining loop.

    The per-cell device rotation (``dev = idx mod k``; read and update
    row ``dev`` of the ready table) is a one-hot mask over the
    PIPE_MAX_K ready rows, so every cell advances with dense tensor ops
    and no per-cell indexing.  ``idx`` and ``k`` are small exact f32
    integers, so the float modulo is exact."""
    kdev, ucie, dev_ui = params[0], params[1], params[2]
    dev_ready = state[0:PIPE_MAX_K]
    link_free, idx = state[PIPE_MAX_K], state[PIPE_MAX_K + 1]
    rep_prev = state[PIPE_MAX_K + 2]
    rows = torch.arange(PIPE_MAX_K, dtype=torch.float32,
                        device=params.device)[:, None]
    for _ in range(chunk):
        dev = idx - torch.floor(idx / kdev) * kdev
        sel = rows == dev[None, :]
        ready = torch.where(sel, dev_ready, 0.0).sum(dim=0)
        start = torch.maximum(ready, link_free)
        dev_ready = torch.where(sel, start + dev_ui, dev_ready)
        link_free = start + ucie
        idx = idx + 1.0

    kf, Kf, ch = scal[0, 0], scal[0, 1], scal[0, 2]
    tol, exit_ok, at_hor = scal[0, 3], scal[0, 4], scal[0, 5]
    n_lines = scal[0, 6]
    T1 = torch.where(kf == 1.0, link_free, hist[0])
    ahat = (link_free - T1) / torch.clamp_min((kf - 1.0) * ch, 1.0)
    rep = n_lines * ucie / torch.clamp_min(
        link_free + ahat * (Kf - kf) * ch, 1e-9)
    delta = torch.abs(rep - rep_prev) / torch.clamp_min(torch.abs(rep),
                                                        1e-9)
    conv = (((delta <= tol) & (exit_ok > 0.0))
            | (at_hor > 0.0)).to(torch.float32)

    pad = torch.zeros_like(link_free)
    return torch.stack(list(dev_ready) + [link_free, idx, rep, conv]
                       + [pad] * (PIPE_ROWS - PIPE_MAX_K - 4))


def pipelining_run_compute(params, *, K: int, chunk: int, tol: float,
                           n_lines: int):
    """A whole adaptive Fig-13 pipelining run, the host loop of the
    reference's ``_run_pipelining_pallas``: one
    :func:`pipelining_chunk_compute` a chunk, the T1 anchor taken after
    chunk 1 and the flag row read back after each chunk, until every cell
    has converged or the horizon chunk ``K``.  Returns ``(state, conv_at,
    k_exit)``."""
    dev = params.device
    cells = params.shape[1]
    min_k = min(_MIN_EXIT_CHUNKS, K)
    state = torch.zeros((PIPE_ROWS, cells), dtype=torch.float32, device=dev)
    hist = torch.zeros((ASYM_ROWS, cells), dtype=torch.float32, device=dev)

    def scal_for(k: int):
        return _scal_row([k, K, chunk, tol, 1.0 if k >= min_k else 0.0,
                          1.0 if k >= K else 0.0, n_lines], dev)

    conv_at = np.full(cells, -1, np.int32)
    k = 0
    while k < K:
        k += 1
        state = pipelining_chunk_compute(params, state, hist, scal_for(k),
                                         chunk=chunk)
        if k == 1:      # T1 anchor for the linear-growth extrapolation
            hist = torch.cat([state[8:9], torch.zeros(
                (ASYM_ROWS - 1, cells), dtype=torch.float32, device=dev)])
        conv_np = (state[11] > 0.5).cpu().numpy()
        conv_at[(conv_at < 0) & conv_np] = k
        if int((~conv_np).sum()) == 0:
            break
    return (state, torch.as_tensor(conv_at, device=dev),
            torch.tensor([k], dtype=torch.int32, device=dev))


def symmetric_trace_compute(params, xs, ys, bls, *, cycles: int):
    """Every cell through all N phases of its trace, ``cycles`` steps a
    phase, the queue/credit core carried across phase boundaries (the
    plain trace-scan core of :mod:`repro_torch.core.flitsim` on
    row-stacked cells): ``[N, C]`` per-phase efficiency."""
    p = SymmetricFlitParams(*[params[i] for i in range(11)])
    return _symmetric_trace_grid(p, xs.unbind(0), ys.unbind(0),
                                 bls.unbind(0), cycles=cycles)


def asymmetric_trace_compute(params, xs, ys, *, cycles: int):
    """The asymmetric trace scan on row-stacked cells: lane clocks and
    credit carried across phases, each phase's efficiency from its
    lane-time delta: ``[N, C]``."""
    p = AsymmetricLaneParams(*[params[i] for i in range(6)])
    return _asymmetric_trace_grid(p, xs.unbind(0), ys.unbind(0),
                                  cycles=cycles)
