"""ctypes binding of the RG-LRU scan CUDA kernel
(``repro_torch/csrc/rglru_scan.cu``).

One thread per (batch, channel), consecutive threads on consecutive
channels, runs the recurrence over the whole sequence in f32.  The
launcher takes contiguous f32 CUDA tensors already checked by
:mod:`repro_torch.kernels.rglru_scan.ops`, allocates the output with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch reports a CUDA error.  The library is built at first use
(:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.rglru_scan.ref import check_operands

_P = ctypes.c_void_p

_LIB = []


def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    if not _LIB:
        lib = _build.load("rglru_scan")
        lib.rglru_scan.argtypes = [_P, _P, _P, ctypes.c_long, ctypes.c_long,
                                   ctypes.c_long, _P]
        lib.rglru_scan.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def rglru_scan(log_a, b):
    """Launch the kernel: log_a, b ``[B, S, C]`` f32 -> h ``[B, S, C]``
    f32."""
    check_operands(log_a, b)
    bsz, s, c = b.shape
    out = torch.empty_like(b)
    err = _lib().rglru_scan(log_a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            bsz, s, c,
                            torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return out
