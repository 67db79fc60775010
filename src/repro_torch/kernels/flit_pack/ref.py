"""Plain PyTorch versions of CXL.Mem-optimized flit packing (paper Fig 8)
— port of :mod:`repro.kernels.flit_pack.ref`.

256 B flit layout (approach E)::

    bytes [0, 240)   : 15 G-slots of 16 B — cache-line data (line i spans
                       4 consecutive G-slots; slots stream across flits)
    bytes [240, 250) : HS-slot (10 B) — one 62-bit request header
    bytes [250, 252) : Flit HDR (protocol id parked for NEXT flit, seq no)
    bytes [252, 254) : Credit
    bytes [254, 256) : CRC — 16-bit XOR-fold checksum over bytes [0, 254)
                       (the spec's CRC polynomial is not published in the
                       paper; a fold checksum stands in)

Byte values are carried as int32 in [0, 256).  Packing N cache lines
(64 B each) takes ceil(4N / 15) flits.  ``pack_flits_ref`` is the plain
version of the CUDA kernel in ``repro_torch/csrc/flit_pack.cu``; the
output is exact int32, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

G_SLOTS = 15
SLOT_BYTES = 16
FLIT_BYTES = 256
HS_BYTES = 10
META_BYTES = 4
LINE_BYTES = 64
DATA_BYTES = G_SLOTS * SLOT_BYTES        # 240
#: bytes the checksum covers (data, HS slot, HDR and credit)
BODY_BYTES = DATA_BYTES + HS_BYTES + META_BYTES      # 254


def flits_needed(n_lines: int) -> int:
    return -(-4 * n_lines // G_SLOTS)


def pack_flits_ref(lines, headers, hdr_meta):
    """lines ``[N, 64]`` int32 bytes; headers ``[F, 10]`` int32 (one
    request per HS slot); hdr_meta ``[F, 4]`` int32 (HDR0, HDR1, CRD0,
    CRD1) -> flits ``[F, 256]`` int32."""
    n = lines.shape[0]
    f = headers.shape[0]
    assert f == flits_needed(n), (f, n)
    slots = lines.reshape(n * 4, SLOT_BYTES)
    pad = f * G_SLOTS - n * 4
    if pad:
        slots = torch.cat([slots, torch.zeros((pad, SLOT_BYTES),
                                              dtype=slots.dtype,
                                              device=slots.device)])
    data = slots.reshape(f, DATA_BYTES)
    body = torch.cat([data, headers, hdr_meta], dim=1)   # [F, 254]
    return torch.cat([body, _xor_fold(body)], dim=1)


def _xor_fold(body):
    """16-bit XOR fold over byte pairs -> ``[F, 2]`` int32: column 0 the
    XOR of the even bytes, column 1 of the odd bytes."""
    f, nb = body.shape
    if nb % 2:
        body = torch.cat([body, torch.zeros((f, 1), dtype=body.dtype,
                                            device=body.device)], dim=1)
    acc = body.reshape(f, -1, 2)
    while acc.shape[1] > 1:         # halving tree; XOR is associative
        if acc.shape[1] % 2:
            acc = torch.cat([acc, torch.zeros_like(acc[:, :1])], dim=1)
        h = acc.shape[1] // 2
        acc = torch.bitwise_xor(acc[:, :h], acc[:, h:])
    return acc[:, 0]


def unpack_flits_ref(flits, n_lines: int):
    """Inverse of pack (drops the padding): -> (lines ``[N, 64]``,
    headers, meta, crc_ok ``[F]`` bool)."""
    f = flits.shape[0]
    body = flits[:, :BODY_BYTES]
    crc = flits[:, BODY_BYTES:]
    ok = (_xor_fold(body) == crc).all(dim=1)
    data = flits[:, :DATA_BYTES].reshape(f * G_SLOTS, SLOT_BYTES)
    lines = data[:n_lines * 4].reshape(n_lines, LINE_BYTES)
    headers = flits[:, DATA_BYTES:DATA_BYTES + HS_BYTES]
    meta = flits[:, DATA_BYTES + HS_BYTES:BODY_BYTES]
    return lines, headers, meta, ok
