"""Launch wrapper of the Mamba2 SSD scan.

A CPU tensor goes to the model's chunked closed form
(:func:`repro_torch.models.ssm.ssd_chunked`, as the reference's wrapper
does off the TPU); a CUDA tensor goes to the CUDA kernel
(:mod:`repro_torch.kernels.ssd_scan.kernel`), or the wrapper raises —
there is no fallback.  :func:`ssd` casts its operands to contiguous f32
and adds one to :data:`launches` where it launches the kernel; the
operands' shapes are checked once, by the CPU path here or by the
kernel's binding before it hands their pointers to the library.  Any sequence length is taken; ``chunk`` is the CPU path's chunk
(the kernel's chunk is its own tile).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ssd_scan import kernel as _k
from repro_torch.kernels.ssd_scan.ref import check_operands

#: CUDA launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"ssd_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def ssd(x, dt, b, c, a_log, chunk: int = 128, init_state=None):
    """x: [B,S,H,P]; dt: [B,S,H]; b, c: [B,S,N]; a_log: [H]; init_state:
    [B,H,P,N] or None (zero) -> (y [B,S,H,P], final_state [B,H,P,N]) f32."""
    ts = (x, dt, b, c, a_log) if init_state is None \
        else (x, dt, b, c, a_log, init_state)
    dev = x.device
    if any(t.device != dev for t in ts):
        raise ValueError(f"ssd_scan: operands on several devices "
                         f"{sorted({str(t.device) for t in ts})}")
    # converted only where needed: each call is host time on short prompts
    ts = tuple(t if t.dtype is torch.float32 and t.is_contiguous()
               else t.float().contiguous() for t in ts)
    x, dt, b, c, a_log = ts[:5]
    init_state = ts[5] if len(ts) > 5 else None
    if dev.type == "cpu":
        from repro_torch.models.ssm import ssd_chunked
        check_operands(x, dt, b, c, a_log, init_state)
        return ssd_chunked(x, dt, b[:, :, None], c[:, :, None], a_log,
                           chunk=min(chunk, x.shape[1]),
                           init_state=init_state)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {dev}")
    out = _k.ssd_scan(x, dt, b, c, a_log, init_state)
    launches["ssd_scan"] += 1
    return out
