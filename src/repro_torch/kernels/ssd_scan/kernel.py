"""ctypes binding of the Mamba2 SSD chunked-scan CUDA kernel
(``repro_torch/csrc/ssd_scan.cu``).

One block per (batch, head, tile of the P head-dim columns) walks the
sequence in chunks of 64 steps, keeping its ``[P-tile, N]`` state in
shared memory.  The launcher takes contiguous f32 CUDA tensors, checks
their shapes (the library itself refuses a state size N above 128 with a
CUDA error), allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch reports a CUDA error.  The library is built at first use
(:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.ssd_scan.ref import check_operands

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = []


def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    if not _LIB:
        lib = _build.load("ssd_scan")
        lib.ssd_scan.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _P]
        lib.ssd_scan.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def ssd_scan(x, dt, b, c, a_log, init_state=None):
    """Launch the kernel: x ``[B,S,H,P]``, dt ``[B,S,H]``, b, c ``[B,S,N]``,
    a_log ``[H]``, initial state ``[B,H,P,N]`` or None (zero), all f32 ->
    (y ``[B,S,H,P]``, final state ``[B,H,P,N]``), f32."""
    check_operands(x, dt, b, c, a_log, init_state)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    fs = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    err = _lib().ssd_scan(x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                          c.data_ptr(), a_log.data_ptr(),
                          None if init_state is None
                          else init_state.data_ptr(), y.data_ptr(),
                          fs.data_ptr(), bsz, s, h, p, n,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    return y, fs
