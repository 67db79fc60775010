"""ctypes bindings of the fused flit-simulator CUDA kernels
(``repro_torch/csrc/flit_sim.cu``).

A one-chunk, periodic or trace launch advances every cell of a
row-stacked ``[rows, cells]`` operand with one thread per cell; the
ragged edge is masked in the kernel, so no padding is needed.  A run launch is one
cooperative grid that takes every cell through a whole adaptive run,
chunk after chunk, one cell a thread, and stops on the card.  Each
launcher takes contiguous f32 CUDA tensors (validated by
:mod:`repro_torch.kernels.flit_sim.ops`), allocates the outputs and
scratch with ``torch.empty`` (the run's chunk counters with
``torch.zeros``), launches on PyTorch's current stream and raises if the
launch reports a CUDA error.  The library is built at first use
(:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.flit_sim.ref import (
    ASYM_ROWS, DRIFT_SPAN, PIPE_ROWS, SYM_PERIODIC_ROWS, SYM_ROWS,
)

_P = ctypes.c_void_p


_LIB = []


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``flit_sim.cu``) with its C signatures
    declared."""
    for fn in (lib.flit_symmetric_chunk, lib.flit_pipelining_chunk):
        fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_long, ctypes.c_int, _P]
    lib.flit_asymmetric_periodic.argtypes = [_P, _P, ctypes.c_long,
                                             ctypes.c_int, _P]
    lib.flit_symmetric_periodic.argtypes = [_P, _P, ctypes.c_long,
                                            ctypes.c_int, _P]
    for fn in (lib.flit_symmetric_run, lib.flit_pipelining_run):
        fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_long, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]
    lib.flit_division_check.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P,
                                        _P]
    lib.flit_symmetric_trace.argtypes = [_P, _P, _P, _P, _P, ctypes.c_long,
                                         ctypes.c_int, ctypes.c_int, _P]
    lib.flit_asymmetric_trace.argtypes = [_P, _P, _P, _P, ctypes.c_long,
                                          ctypes.c_int, ctypes.c_int, _P]
    for fn in (lib.flit_symmetric_chunk, lib.flit_asymmetric_periodic,
               lib.flit_symmetric_periodic, lib.flit_pipelining_chunk,
               lib.flit_symmetric_run, lib.flit_pipelining_run,
               lib.flit_division_check, lib.flit_symmetric_trace,
               lib.flit_asymmetric_trace):
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    if not _LIB:
        _LIB.append(declare(_build.load("flit_sim")))
    return _LIB[0]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _out(rows: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty((rows, like.shape[1]), dtype=torch.float32,
                       device=like.device)


def symmetric_chunk(params, state, hist, scal, *, chunk: int):
    """Launch one adaptive symmetric chunk: ``[SYM_ROWS, C]`` from
    ``params`` / ``state`` / ``hist`` ``[SYM_ROWS, C]`` and ``scal``
    ``[1, SCAL_COLS]``."""
    out = _out(SYM_ROWS, params)
    err = _lib().flit_symmetric_chunk(
        params.data_ptr(), state.data_ptr(), hist.data_ptr(),
        scal.data_ptr(), out.data_ptr(), params.shape[1], int(chunk),
        _stream(params))
    _raise_on(err, "symmetric_chunk")
    return out


def asymmetric_periodic(params, *, n_accesses: int):
    """Launch the period-exact asymmetric run: ``[ASYM_ROWS, C]``."""
    out = _out(ASYM_ROWS, params)
    err = _lib().flit_asymmetric_periodic(
        params.data_ptr(), out.data_ptr(), params.shape[1],
        int(n_accesses), _stream(params))
    _raise_on(err, "asymmetric_periodic")
    return out


def symmetric_periodic(params, *, n_flits: int):
    """Launch the period-exact symmetric run: ``[SYM_PERIODIC_ROWS,
    C]``."""
    out = _out(SYM_PERIODIC_ROWS, params)
    err = _lib().flit_symmetric_periodic(
        params.data_ptr(), out.data_ptr(), params.shape[1], int(n_flits),
        _stream(params))
    _raise_on(err, "symmetric_periodic")
    return out


def pipelining_chunk(params, state, hist, scal, *, chunk: int):
    """Launch one adaptive pipelining chunk: ``[PIPE_ROWS, C]`` from
    ``params`` / ``state`` ``[PIPE_ROWS, C]``, ``hist`` ``[ASYM_ROWS, C]``
    and ``scal`` ``[1, SCAL_COLS]``."""
    out = _out(PIPE_ROWS, params)
    err = _lib().flit_pipelining_chunk(
        params.data_ptr(), state.data_ptr(), hist.data_ptr(),
        scal.data_ptr(), out.data_ptr(), params.shape[1], int(chunk),
        _stream(params))
    _raise_on(err, "pipelining_chunk")
    return out


def _run_outputs(rows: int, params, K: int):
    cells = params.shape[1]
    conv_at = torch.empty(cells, dtype=torch.int32, device=params.device)
    track = torch.zeros(K + 1, dtype=torch.int32, device=params.device)
    return _out(rows, params), conv_at, track


def symmetric_run(params, *, K: int, chunk: int, tol: float, budget: int):
    """Launch one whole adaptive symmetric run: ``(state [SYM_ROWS, C],
    conv_at [C] int32, k_exit [1] int32)``."""
    cells = params.shape[1]
    out, conv_at, track = _run_outputs(SYM_ROWS, params, K)
    hist = torch.empty((2 * K + 5 * int(DRIFT_SPAN), cells),
                       dtype=torch.float32, device=params.device)
    err = _lib().flit_symmetric_run(
        params.data_ptr(), out.data_ptr(), hist.data_ptr(),
        conv_at.data_ptr(), track.data_ptr(), cells, int(chunk), int(K),
        float(tol), int(budget), _stream(params))
    _raise_on(err, "symmetric_run")
    return out, conv_at, track[:1]


def pipelining_run(params, *, K: int, chunk: int, tol: float,
                   n_lines: int):
    """Launch one whole adaptive pipelining run: ``(state [PIPE_ROWS, C],
    conv_at [C] int32, k_exit [1] int32)``."""
    cells = params.shape[1]
    out, conv_at, track = _run_outputs(PIPE_ROWS, params, K)
    anchor = torch.empty(cells, dtype=torch.float32, device=params.device)
    err = _lib().flit_pipelining_run(
        params.data_ptr(), out.data_ptr(), anchor.data_ptr(),
        conv_at.data_ptr(), track.data_ptr(), cells, int(chunk), int(K),
        float(tol), int(n_lines), _stream(params))
    _raise_on(err, "pipelining_run")
    return out, conv_at, track[:1]


def symmetric_trace(params, xs, ys, bls, *, cycles: int):
    """Launch the symmetric trace scan: ``[N, C]`` from ``params``
    ``[SYM_ROWS, C]`` and the phase rows ``xs`` / ``ys`` / ``bls``
    ``[N, C]``."""
    out = _out(xs.shape[0], params)
    err = _lib().flit_symmetric_trace(
        params.data_ptr(), xs.data_ptr(), ys.data_ptr(), bls.data_ptr(),
        out.data_ptr(), params.shape[1], xs.shape[0], int(cycles),
        _stream(params))
    _raise_on(err, "symmetric_trace")
    return out


def asymmetric_trace(params, xs, ys, *, cycles: int):
    """Launch the asymmetric trace scan: ``[N, C]`` from ``params``
    ``[ASYM_ROWS, C]`` and the phase rows ``xs`` / ``ys`` ``[N, C]``."""
    out = _out(xs.shape[0], params)
    err = _lib().flit_asymmetric_trace(
        params.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
        params.shape[1], xs.shape[0], int(cycles), _stream(params))
    _raise_on(err, "asymmetric_trace")
    return out


def division_check(d_bits: torch.Tensor, *, varying: bool) -> int:
    """Pairs (x, d), x over every f32 significand in [1, 2) and d over the
    f32 bit patterns ``d_bits`` (an int32 CUDA tensor), whose quotient
    through the run kernels' division by a cell constant (or, ``varying``,
    by ``tot_q``) differs from the IEEE quotient in any bit (for the
    varying divisor, plus each exponent in [-50, 50] at which the
    approximate reciprocal does not scale).  Synchronises."""
    bad = torch.zeros(1, dtype=torch.int64, device=d_bits.device)
    err = _lib().flit_division_check(d_bits.data_ptr(), d_bits.numel(),
                                     int(varying), bad.data_ptr(),
                                     _stream(d_bits))
    _raise_on(err, "division_check")
    return int(bad.item())
