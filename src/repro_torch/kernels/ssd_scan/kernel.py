"""ctypes binding of the Mamba2 SSD scan CUDA kernels
(``repro_torch/csrc/ssd_scan.cu``).

The scan runs as chunk-parallel stages, each a kernel with 3xTF32
tensor-core products: per (batch, chunk) the cumulative decay sums and
C Bᵀ once for all heads; per (batch, chunk, head, 64 columns of P) the
chunk's state; per state element the pass that hands the states from
chunk to chunk; per (batch, chunk, head, 64 columns of P) the outputs.
A sequence of at most 16 steps takes one kernel that does all of it.
One C call launches them in order on PyTorch's current stream.  The
launcher takes contiguous f32 CUDA tensors, checks their shapes (the
library itself refuses a state size N above 128 with a CUDA error),
allocates the outputs and the stages' scratch with ``torch.empty`` and
raises if a launch reports a CUDA error.  The library is built at first
use (:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.ssd_scan.ref import check_operands

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the loaded library, its chunk length Q and the longest sequence of its
#: one-launch path
_LIB = []


def _lib():
    """(the built library with its C signatures declared, Q, the one-launch
    path's longest sequence), loaded once."""
    if not _LIB:
        lib = _build.load("ssd_scan")
        lib.ssd_scan.argtypes = [_P] * 9 + [_I] * 6 + [_P]
        lib.ssd_scan.restype = ctypes.c_int
        _LIB.extend((lib, lib.ssd_scan_chunk(), lib.ssd_scan_short_rows()))
    return _LIB


def ssd_scan(x, dt, b, c, a_log, init_state=None):
    """Launch the stages: x ``[B,S,H,P]``, dt ``[B,S,H]``, b, c ``[B,S,N]``,
    a_log ``[H]``, initial state ``[B,H,P,N]`` or None (zero), all f32 ->
    (y ``[B,S,H,P]``, final state ``[B,H,P,N]``), f32."""
    check_operands(x, dt, b, c, a_log, init_state)
    lib, q, short = _lib()
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // q)
    y = torch.empty_like(x)
    fs = x.new_empty((bsz, h, p, n))
    # one scratch buffer: per (batch, chunk) the cumulative sums and dt of
    # every head, C Bᵀ and, unless one chunk has no initial state (the
    # first stage then writes the final state directly), the chunk states;
    # none for a sequence the one-launch path takes
    states = 0 if nc <= 1 and init_state is None else h * p * n
    scratch = None if s <= short else x.new_empty(
        bsz * nc * (3 * h * q + q * q + states))
    ptrs = (x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            a_log.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), fs.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    # 16-byte copies need aligned pointers and rows of whole 16 bytes
    bits = 0
    for ptr in ptrs:
        bits |= ptr or 0
    vec = int(p % 4 == 0 and n % 4 == 0 and bits % 16 == 0)
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object, several microseconds of the host time that sets short calls
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    err = lib.ssd_scan(*ptrs, bsz, s, h, p, n, vec, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    return y, fs
