"""ctypes binding of the decode-attention CUDA kernels
(``repro_torch/csrc/decode_attention.cu``).

One call launches three kernels on PyTorch's current stream: the scores of
each chunk of live positions with the chunk's max and sum, the chunk's
softmax weights and weighted sum of V, and the fixed-order merge of the
chunks.  The launcher takes contiguous CUDA tensors already checked by
:mod:`repro_torch.kernels.decode_attention.ops`, allocates the output and
one f32 scratch tensor with ``torch.empty``, and raises if a launch
reports a CUDA error.  The chunk length adapts to the shapes it is given
(:func:`chunk_rows`).  The library is built at first use
(:mod:`repro_torch._build`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels.decode_attention.ref import HEAD_DIMS, MAX_GROUP

#: positions a block covers at most, and at least
CHUNK_MAX, CHUNK_MIN = 256, 16
#: blocks a streaming multiprocessor that the chunking aims for
BLOCKS_PER_SM = 8

_P = ctypes.c_void_p
_I = ctypes.c_int

_LIB = []


def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    if not _LIB:
        lib = _build.load("decode_attention")
        lib.decode_attention.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _P]
        lib.decode_attention.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_rows(b: int, kh: int, s: int, sms: int) -> int:
    """Positions a block covers: the largest power of two up to
    ``CHUNK_MAX`` at which ``b * kh * ceil(s / C)`` blocks still number
    ``BLOCKS_PER_SM`` a multiprocessor, and no less than ``CHUNK_MIN``."""
    c = CHUNK_MAX
    while c > CHUNK_MIN and b * kh * -(-s // c) < BLOCKS_PER_SM * sms:
        c //= 2
    return c


def decode_attention(q, k_cache, v_cache, lengths, *, scale: float):
    """Launch the kernels: q ``[B,1,K,G,hd]``, caches ``[B,S,K,hd]`` (f32
    or bf16, contiguous, 16-byte aligned), ``lengths`` int32 ``[B]`` on
    the same card -> ``[B,1,K,G,hd]`` in q's dtype."""
    b, _, kh, g, hd = q.shape
    s = k_cache.shape[1]
    assert hd in HEAD_DIMS and g <= MAX_GROUP, (hd, g)
    c = chunk_rows(b, kh, s, _sms(q.device.index))
    nc = -(-s // c)
    rows = b * kh * g
    out = torch.empty_like(q)
    work = torch.empty(rows * (s + 2 * nc + nc * hd), dtype=torch.float32,
                       device=q.device)
    scores, cmax, csum, partial = torch.split(
        work, [rows * s, rows * nc, rows * nc, rows * nc * hd])
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = _lib().decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), scores.data_ptr(),
        cmax.data_ptr(), csum.data_ptr(), partial.data_ptr(),
        1 if q.dtype == torch.bfloat16 else 0, b, s, kh, g, hd, c, scale,
        stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    return out
