"""ctypes binding of the RG-LRU scan CUDA kernel
(``repro_torch/csrc/rglru_scan.cu``).

A block owns a narrow slice of channels of one batch row and runs their
recurrence step by step, in the plain version's order, from a ring of
shared-memory stages over S that one producer warp keeps full (TMA where
the rows and both operands are 16-byte aligned, else 4-byte ``cp.async``
copies).  :func:`plan` is the host's side of that choice, a plain function
of the shape and the operands' addresses.  The launcher takes contiguous
f32 CUDA tensors (:mod:`repro_torch.kernels.rglru_scan.ops` makes them),
checks their shape, allocates the output with ``torch.empty``, launches
on PyTorch's current stream and raises if the launch reports a CUDA
error.  The library is built at first use (:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch import _build
from repro_torch.kernels.rglru_scan.ref import check_operands

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int

#: the kernel's constants (``csrc/rglru_scan.cu``): a block's channels, a
#: ring stage's steps x channels and the ring's stages.  Serving prefills
#: one request at a time, so B = 1 decides: there W = 16 was the fastest
#: in ``launch/probe_rglru.py``'s A/B and 4 stages tied with 6, the smaller
#: ring (``PERF.md`` §6 has the batched reading too)
WIDTH = 16
TILE = 1024
STAGES = 4

_LIB = []


class Plan(NamedTuple):
    route: str       # "tma" or "cp.async"
    width: int       # channels of a block
    tile: int        # steps of a ring stage
    stages: int      # stages of the ring
    blocks: int      # B x ceil(C / width)


def plan(shape: Sequence[int], ptrs: Sequence[int]) -> Plan:
    """The launch of one call on ``[B, S, C]`` operands at addresses
    ``ptrs`` (log_a, b).  TMA needs C % 4 == 0 and both addresses 16-byte
    aligned (an offset view is not); elsewhere the ring is filled by
    cp.async."""
    bsz, _, c = shape
    tma = c % 4 == 0 and not (ptrs[0] | ptrs[1]) % 16
    return Plan("tma" if tma else "cp.async", WIDTH, TILE // WIDTH, STAGES,
                bsz * -(-c // WIDTH))


def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    if not _LIB:
        lib = _build.load("rglru_scan")
        lib.rglru_scan.argtypes = [_P, _P, _P, _L, _L, _L, _I, _P]
        lib.rglru_scan.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def rglru_scan(log_a, b):
    """Launch the kernel: log_a, b ``[B, S, C]`` f32 -> h ``[B, S, C]``
    f32."""
    check_operands(log_a, b)
    bsz, s, c = b.shape
    out = torch.empty_like(b)
    ptrs = (log_a.data_ptr(), b.data_ptr())
    route = plan(b.shape, ptrs).route
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object, several microseconds of the host time that sets short calls
    stream = torch._C._cuda_getCurrentRawStream(b.device.index)
    err = _lib().rglru_scan(*ptrs, out.data_ptr(), bsz, s, c,
                            int(route == "tma"), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return out
