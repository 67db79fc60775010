"""ctypes bindings of the fused flit-simulator CUDA kernels
(``repro_torch/csrc/flit_sim.cu``).

One launch advances every cell of a row-stacked ``[rows, cells]``
operand with one thread per cell; the ragged edge is masked in the
kernel, so no padding is needed.  Each launcher takes contiguous f32
CUDA tensors (validated by :mod:`repro_torch.kernels.flit_sim.ops`),
allocates the output rows with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch reports a CUDA error.  The library is built at first use
(:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.flit_sim.ref import (
    ASYM_ROWS, PIPE_ROWS, SYM_PERIODIC_ROWS, SYM_ROWS,
)

_P = ctypes.c_void_p


_LIB = []


def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    if not _LIB:
        lib = _build.load("flit_sim")
        for fn in (lib.flit_symmetric_chunk, lib.flit_pipelining_chunk):
            fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_long, ctypes.c_int,
                           _P]
        lib.flit_asymmetric_periodic.argtypes = [_P, _P, ctypes.c_long,
                                                 ctypes.c_int, _P]
        lib.flit_symmetric_periodic.argtypes = [_P, _P, ctypes.c_long,
                                                ctypes.c_int, _P]
        for fn in (lib.flit_symmetric_chunk, lib.flit_asymmetric_periodic,
                   lib.flit_symmetric_periodic, lib.flit_pipelining_chunk):
            fn.restype = ctypes.c_int
        _LIB.append(lib)
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
