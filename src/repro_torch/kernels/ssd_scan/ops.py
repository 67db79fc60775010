"""Launch wrapper of the Mamba2 SSD scan, and its gradient.

A CPU tensor goes to the model's chunked closed form
(:func:`repro_torch.models.ssm.ssd_chunked`, as the reference's wrapper
does off the TPU), which autograd differentiates directly; a CUDA tensor
goes to the CUDA kernel (:mod:`repro_torch.kernels.ssd_scan.kernel`), or
the wrapper raises — there is no fallback.  :func:`ssd` casts its
operands to contiguous f32 and adds one to :data:`launches` where it
launches the kernel; the operands' shapes are checked once, by the CPU
path here or by the kernel's binding before it hands their pointers to
the library.  Any sequence length is taken; ``chunk`` is the chunked
form's chunk (the kernel's chunk is its own tile).

Gradients: where an operand needs one, the CUDA path runs through
:class:`SSDScan`, whose forward is the kernel and whose backward is the
VJP of ``ssd_chunked`` by recompute from the saved operands — the
function the reference's training path differentiates.  There is no
backward kernel.

A fake tensor (the dry run, :mod:`repro_torch.roofline.counts`) goes to
the operator ``repro_torch::ssd_scan``, whose count is the einsums of the
reference's ``ssd_chunked`` at ``chunk``; in training it runs under
:class:`SSDScan` as the kernel does.  Real tensors never reach the
operator.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel as _k
from repro_torch.kernels.ssd_scan.ref import check_operands
from repro_torch.roofline import counts

#: CUDA launches since the last :func:`reset_launches`
launches: Dict[str, int] = {"ssd_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def chunked(x, dt, b, c, a_log, chunk: int, init_state=None):
    """:func:`repro_torch.models.ssm.ssd_chunked` on one B/C group
    (b, c ``[B, S, N]``) at ``min(chunk, S)``."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, b[:, :, None], c[:, :, None], a_log,
                       chunk=min(chunk, x.shape[1]), init_state=init_state)


class SSDScan(torch.autograd.Function):
    """``scan(x, dt, b, c, a_log, init_state)`` forward (the kernel on the
    card; a test may pass ``ssd_ref``), the VJP of :func:`chunked` at
    ``chunk`` by recompute backward.  An output whose gradient is not
    asked for (the final state, in training) is left out of the VJP."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a_log, init_state, chunk, scan):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, b, c, a_log, init_state)
        ctx.chunk = chunk
        return scan(x, dt, b, c, a_log, init_state)

    @staticmethod
    def backward(ctx, gy, gfs):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(True)
                   for t in saved]
            outs = chunked(*ins[:5], ctx.chunk, init_state=ins[5])
            pairs = [(o, g) for o, g in zip(outs, (gy, gfs))
                     if g is not None]
            if not pairs:
                return (None,) * 8
            need = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], need, [g for _, g in pairs],
                allow_unused=True))
        return (*[None if t is None else next(grads) for t in ins],
                None, None)


def _launch(x, dt, b, c, a_log, init_state):
    out = _k.ssd_scan(x, dt, b, c, a_log, init_state)
    launches["ssd_scan"] += 1
    return out


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _scan_op(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a_log: torch.Tensor,
             init_state: Optional[torch.Tensor], chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    y, fs = ssd(x, dt, b, c, a_log, chunk, init_state)
    return y.clone(), fs.clone()


@_scan_op.register_fake
def _(x, dt, b, c, a_log, init_state, chunk):
    bsz, _, h, p = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    return torch.empty(x.shape, **f32), \
        torch.empty((bsz, h, p, b.shape[-1]), **f32)


def scan_flops(x, dt, b, c, a_log, init_state, chunk) -> float:
    """The einsums of ``ssd_chunked`` (one B/C group) at chunk ``Q =
    min(chunk, S)`` over ``ceil(S / Q)`` chunks: C B^T (Q x Q x N), its
    product with x (Q x Q x P a head), the chunk states and their read
    back (N x P x Q a head, each)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    return 2.0 * bsz * nc * q * (q * n + h * q * p + 2 * h * n * p)


counts.register_formula("repro_torch::ssd_scan", scan_flops)


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
    if counts.is_fake(x):
        traced = lambda *a: _scan_op(*a, chunk)
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            return SSDScan.apply(x, dt, b, c, a_log, init_state, chunk,
                                 traced)
        return traced(x, dt, b, c, a_log, init_state)
    if dev.type == "cpu":
        check_operands(x, dt, b, c, a_log, init_state)
        return chunked(x, dt, b, c, a_log, chunk, init_state)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return SSDScan.apply(x, dt, b, c, a_log, init_state, chunk, _launch)
    return _launch(x, dt, b, c, a_log, init_state)
