"""Launch wrapper of the flit packer.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.
flit_pack.ref`); a CUDA tensor goes to the CUDA kernel
(:mod:`repro_torch.kernels.flit_pack.kernel`), or the wrapper raises —
there is no fallback.  :func:`pack` checks device, dtype, shape and
contiguity and adds one to :data:`launches` where it launches the kernel.
Unpacking is a plain slice-and-fold on either device.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flit_pack import kernel as _k
from repro_torch.kernels.flit_pack.ref import (
    HS_BYTES, LINE_BYTES, META_BYTES, flits_needed, pack_flits_ref,
    unpack_flits_ref,
)

#: CUDA launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"pack_flits": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def pack(lines, headers, hdr_meta):
    """Pack ``lines`` ``[N, 64]`` with ``headers`` ``[F, 10]`` and
    ``hdr_meta`` ``[F, 4]`` (int32 bytes, ``F == flits_needed(N)``) into
    ``[F, 256]`` int32 flits."""
    ts = (lines, headers, hdr_meta)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"pack: operands on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pack: no kernel for device {dev}")
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.ndim != 2:
            raise ValueError(f"pack: operands must be contiguous 2-D int32 "
                             f"tensors, got {t.dtype} {tuple(t.shape)}")
    n, f = lines.shape[0], headers.shape[0]
    if f != flits_needed(n):
        raise ValueError(f"pack: {f} flits given for {n} lines, need "
                         f"flits_needed({n}) = {flits_needed(n)}")
    for t, width in ((lines, LINE_BYTES), (headers, HS_BYTES),
                     (hdr_meta, META_BYTES)):
        if t.shape[1] != width or (t is hdr_meta and t.shape[0] != f):
            raise ValueError(f"pack: bad operand shape {tuple(t.shape)}")
    if dev.type == "cpu":
        return pack_flits_ref(lines, headers, hdr_meta)
    out = _k.pack_flits(lines, headers, hdr_meta)
    launches["pack_flits"] += 1
    return out


unpack = unpack_flits_ref
