"""Launch wrappers of the fused flit-simulator kernels.

A CPU tensor goes to the kernel's plain version
(:mod:`repro_torch.kernels.flit_sim.ref`); a CUDA tensor goes to the CUDA
kernel (:mod:`repro_torch.kernels.flit_sim.kernel`, which allocates the
output with ``torch.empty``), or the wrapper raises — there is no
fallback.  Each wrapper checks device, dtype, shape and contiguity and
adds one to its entry of :data:`launches` where it launches the kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flit_sim import kernel as _k
from repro_torch.kernels.flit_sim import ref as _ref
from repro_torch.kernels.flit_sim.ref import (
    ASYM_ROWS, PIPE_ROWS, SCAL_COLS, SYM_ROWS,
)

#: the trace-scan kernels (port kernels with no TPU counterpart)
TRACE_KERNELS = ("symmetric_trace", "asymmetric_trace")

#: CUDA launches per kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"symmetric_chunk": 0, "symmetric_run": 0,
                            "asymmetric_periodic": 0,
                            "symmetric_periodic": 0, "pipelining_chunk": 0,
                            "pipelining_run": 0,
                            **{name: 0 for name in TRACE_KERNELS}}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA operands (checked for the kernel's contract), False
    for CPU operands; raises on a mix or on any other device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.ndim != 2:
            raise ValueError(f"{name}: operands must be contiguous 2-D f32 "
                             f"tensors, got {t.dtype} {tuple(t.shape)}")
    return True


def _check_rows(name: str, t: torch.Tensor, rows: int, cells: int) -> None:
    if tuple(t.shape) != (rows, cells):
        raise ValueError(f"{name}: expected shape {(rows, cells)}, got "
                         f"{tuple(t.shape)}")


def symmetric_chunk(params, state, hist, scal, *, chunk: int):
    """One adaptive symmetric chunk: the new ``[SYM_ROWS, C]`` state rows
    (row 11 is the convergence flag)."""
    if not _on_cuda("symmetric_chunk", params, state, hist, scal):
        return _ref.symmetric_chunk_compute(params, state, hist, scal,
                                            chunk=chunk)
    cells = params.shape[1]
    for t in (params, state, hist):
        _check_rows("symmetric_chunk", t, SYM_ROWS, cells)
    _check_rows("symmetric_chunk", scal, 1, SCAL_COLS)
    out = _k.symmetric_chunk(params, state, hist, scal, chunk=chunk)
    launches["symmetric_chunk"] += 1
    return out


def _check_run(name: str, params, rows: int, K: int, chunk: int) -> None:
    _check_rows(name, params, rows, params.shape[1])
    if K < 1 or chunk < 1:
        raise ValueError(f"{name}: need K >= 1 and chunk >= 1, got K={K} "
                         f"chunk={chunk}")


def symmetric_run(params, *, K: int, chunk: int, tol: float, budget: int):
    """A whole adaptive symmetric run of up to ``K`` chunks of ``chunk``
    cycles, ending after the first chunk that leaves at most ``budget``
    cells unconverged: ``(state [SYM_ROWS, C], conv_at [C] int32,
    k_exit [1] int32)``, ``conv_at`` each cell's first converged chunk
    (-1: none)."""
    if not _on_cuda("symmetric_run", params):
        return _ref.symmetric_run_compute(params, K=K, chunk=chunk, tol=tol,
                                          budget=budget)
    _check_run("symmetric_run", params, SYM_ROWS, K, chunk)
    out = _k.symmetric_run(params, K=K, chunk=chunk, tol=tol, budget=budget)
    launches["symmetric_run"] += 1
    return out


def asymmetric_periodic(params, *, n_accesses: int):
    """Period-exact asymmetric run: ``[ASYM_ROWS, C]`` rows (0 rep,
    1 detected, 2 period)."""
    if not _on_cuda("asymmetric_periodic", params):
        return _ref.asymmetric_periodic_compute(params,
                                                n_accesses=n_accesses)
    if n_accesses < _ref.PERIOD_OBS:
        raise ValueError(f"n_accesses must be >= {_ref.PERIOD_OBS}")
    _check_rows("asymmetric_periodic", params, ASYM_ROWS, params.shape[1])
    out = _k.asymmetric_periodic(params, n_accesses=n_accesses)
    launches["asymmetric_periodic"] += 1
    return out


def symmetric_periodic(params, *, n_flits: int):
    """Period-exact symmetric run: ``[SYM_PERIODIC_ROWS, C]`` rows
    (0 rep, 1 detected, 2 period)."""
    if not _on_cuda("symmetric_periodic", params):
        return _ref.symmetric_periodic_compute(params, n_flits=n_flits)
    if n_flits // 4 < _ref.SYM_PERIOD_OBS:
        raise ValueError(f"n_flits // 4 must be >= {_ref.SYM_PERIOD_OBS}")
    _check_rows("symmetric_periodic", params, SYM_ROWS, params.shape[1])
    out = _k.symmetric_periodic(params, n_flits=n_flits)
    launches["symmetric_periodic"] += 1
    return out


def pipelining_chunk(params, state, hist, scal, *, chunk: int):
    """One adaptive Fig-13 pipelining chunk: the new ``[PIPE_ROWS, C]``
    state rows (row 11 is the convergence flag)."""
    if not _on_cuda("pipelining_chunk", params, state, hist, scal):
        return _ref.pipelining_chunk_compute(params, state, hist, scal,
                                             chunk=chunk)
    cells = params.shape[1]
    for t in (params, state):
        _check_rows("pipelining_chunk", t, PIPE_ROWS, cells)
    _check_rows("pipelining_chunk", hist, ASYM_ROWS, cells)
    _check_rows("pipelining_chunk", scal, 1, SCAL_COLS)
    out = _k.pipelining_chunk(params, state, hist, scal, chunk=chunk)
    launches["pipelining_chunk"] += 1
    return out


def pipelining_run(params, *, K: int, chunk: int, tol: float, n_lines: int):
    """A whole adaptive Fig-13 run of up to ``K`` chunks of ``chunk``
    lines over a horizon of ``n_lines``, ending when every cell has
    converged: ``(state [PIPE_ROWS, C], conv_at [C] int32, k_exit [1]
    int32)``."""
    if not _on_cuda("pipelining_run", params):
        return _ref.pipelining_run_compute(params, K=K, chunk=chunk, tol=tol,
                                           n_lines=n_lines)
    _check_run("pipelining_run", params, PIPE_ROWS, K, chunk)
    out = _k.pipelining_run(params, K=K, chunk=chunk, tol=tol,
                            n_lines=n_lines)
    launches["pipelining_run"] += 1
    return out


def _check_trace(name: str, params, rows: int, cycles: int,
                 *phases) -> None:
    cells = params.shape[1]
    _check_rows(name, params, rows, cells)
    for t in phases:
        _check_rows(name, t, phases[0].shape[0], cells)
    if phases[0].shape[0] < 1 or not 1 <= cycles <= 1 << 24:
        raise ValueError(f"{name}: need >= 1 phase and 1 <= cycles <= "
                         f"2^24, got {phases[0].shape[0]} phases, cycles "
                         f"{cycles}")


def symmetric_trace(params, xs, ys, bls, *, cycles: int):
    """Every cell's trace, phase after phase, the queue/credit core carried
    across phase boundaries: ``[N, C]`` per-phase efficiency from
    ``params`` ``[SYM_ROWS, C]`` and the phase rows ``xs`` / ``ys`` /
    ``bls`` ``[N, C]``."""
    if not _on_cuda("symmetric_trace", params, xs, ys, bls):
        return _ref.symmetric_trace_compute(params, xs, ys, bls,
                                            cycles=cycles)
    _check_trace("symmetric_trace", params, SYM_ROWS, cycles, xs, ys, bls)
    out = _k.symmetric_trace(params, xs, ys, bls, cycles=cycles)
    launches["symmetric_trace"] += 1
    return out


def asymmetric_trace(params, xs, ys, *, cycles: int):
    """The asymmetric trace scan: ``[N, C]`` per-phase efficiency from
    ``params`` ``[ASYM_ROWS, C]`` and the phase rows ``xs`` / ``ys``
    ``[N, C]``."""
    if not _on_cuda("asymmetric_trace", params, xs, ys):
        return _ref.asymmetric_trace_compute(params, xs, ys, cycles=cycles)
    _check_trace("asymmetric_trace", params, ASYM_ROWS, cycles, xs, ys)
    out = _k.asymmetric_trace(params, xs, ys, cycles=cycles)
    launches["asymmetric_trace"] += 1
    return out
