"""ctypes binding of the flit-packing CUDA kernel
(``repro_torch/csrc/flit_pack.cu``).

One warp packs one 256 B flit (8 flits per block): lane j writes bytes
``j + 32 i``, so the stores of a warp are coalesced, and a shuffle
butterfly folds the checksum.  The launcher takes contiguous int32 CUDA
tensors (validated by :mod:`repro_torch.kernels.flit_pack.ops`),
allocates the flits with ``torch.empty``, launches on PyTorch's current
stream and raises if the launch reports a CUDA error.  The library is
built at first use (:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.flit_pack.ref import FLIT_BYTES

_P = ctypes.c_void_p

_LIB = []


def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    if not _LIB:
        lib = _build.load("flit_pack")
        lib.flit_pack.argtypes = [_P, _P, _P, _P, ctypes.c_long,
                                  ctypes.c_long, _P]
        lib.flit_pack.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def pack_flits(lines, headers, hdr_meta):
    """Launch the packer: ``[F, FLIT_BYTES]`` int32 flits from ``lines``
    ``[N, 64]``, ``headers`` ``[F, 10]`` and ``hdr_meta`` ``[F, 4]``."""
    n, f = lines.shape[0], headers.shape[0]
    out = torch.empty((f, FLIT_BYTES), dtype=torch.int32,
                      device=lines.device)
    err = _lib().flit_pack(
        lines.data_ptr(), headers.data_ptr(), hdr_meta.data_ptr(),
        out.data_ptr(), n, f,
        torch.cuda.current_stream(lines.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pack_flits launch failed: CUDA error {err}")
    return out
