"""ctypes binding of the flash-attention forward CUDA kernel
(``repro_torch/csrc/flash_attention.cu``).

One block of 8 warps takes 16 (query row, head) pairs of one (batch, KV
head) slab, two pairs a warp, so the G query heads of a KV head share
every key/value tile it stages in shared memory; the block walks only the
key tiles its rows can see (causal and window bounds).  The launcher takes
contiguous CUDA tensors already checked by
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
            ctypes.c_float, _P]
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
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        1 if q.dtype == torch.bfloat16 else 0, b, kh, g, sq, skv, hd,
        int(causal), int(window), int(q_offset), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    return out
