"""ctypes binding of the flash-attention forward CUDA kernels
(``repro_torch/csrc/flash_attention.cu``).

bf16 operands go to the tensor-core kernel: a consumer warpgroup of 4
warps owns 64 query rows of one (batch, KV head, query head), one or two of
them a block share each 64-key K/V tile, which a producer warpgroup loads
by TMA into a ring of two stages; Q Kᵀ and P V run as ``wgmma`` with f32
sums.  f32 operands go to the CUDA-core kernel (8 warps per 16 (query row,
head) pairs).  Both walk
only the key tiles their rows can see (causal and window bounds).  The
launcher takes contiguous CUDA tensors already checked by
:mod:`repro_torch.kernels.flash_attention.ops`, allocates the output with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch reports a CUDA error.  The library is built at first use
(:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.flash_attention.ref import MAX_HEAD_DIM

_P = ctypes.c_void_p
_I = ctypes.c_int

_LIB = []


def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    if not _LIB:
        lib = _build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _I, _P]
        lib.flash_attention_fwd.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def flash_attention_fwd(q, k, v, *, causal: bool, window: int,
                        q_offset: int, scale: float):
    """Launch the kernel: q ``[B,K,G,Sq,hd]``, k/v ``[B,K,Skv,hd]`` (f32
    or bf16, contiguous, hd <= 256) -> ``[B,K,G,Sq,hd]`` in q's dtype."""
    b, kh, g, sq, hd = q.shape
    skv = k.shape[2]
    assert hd <= MAX_HEAD_DIM, hd
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    # TMA needs hd % 8 == 0 and 16-byte aligned rows; else the kernel
    # stages tiles with element loads
    vec = int(hd % 8 == 0 and (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16
              == 0)
    # the raw stream handle: torch.cuda.current_stream() builds a Stream
    # object, several microseconds of the host time that sets short calls
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = _lib().flash_attention_fwd(
        *ptrs, 1 if q.dtype == torch.bfloat16 else 0, b, kh, g, sq, skv, hd,
        int(causal), int(window), int(q_offset), scale, vec, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    return out
