"""Launch wrapper of the RG-LRU scan, and its gradient.

A CPU tensor goes to the plain version (:func:`repro_torch.kernels.
rglru_scan.ref.lru_ref`), which autograd differentiates directly; a CUDA
tensor goes to the CUDA kernel (:mod:`repro_torch.kernels.rglru_scan.
kernel`), or the wrapper raises — there is no fallback.  :func:`lru`
casts its operands to contiguous f32 (as the reference's wrapper does)
and adds one to :data:`launches` where it launches the kernel; the
operands' shapes are checked once, by the CPU path here or by the
kernel's binding.  Any sequence length is taken.

Gradients: where an operand needs one, the CUDA path runs through
:class:`LRUScan`.  The adjoint of h_t = a_t h_{t-1} + b_t is the same
recurrence run backward in time (:func:`lru_adjoint`), so the backward is
one more launch of the same kernel on time-reversed operands plus two
elementwise products: the gradient the reference takes by
differentiating its ``lru_scan``, with no S-step loop on the card.

A fake tensor (the dry run, :mod:`repro_torch.roofline.counts`) goes to
the operator ``repro_torch::rglru_scan`` (no matmul: 0 FLOPs), forward and
adjoint alike, so a traced step never unrolls the scan.  Real tensors
never reach the operator.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.rglru_scan import kernel as _k
from repro_torch.kernels.rglru_scan.ref import check_operands, lru_ref
from repro_torch.roofline import counts

#: CUDA launches since the last :func:`reset_launches` (forward and
#: backward scans alike)
launches: Dict[str, int] = {"rglru_scan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def lru_adjoint(log_a, h, dh, scan):
    """The gradients (dlog_a, db) of h = scan(log_a, b) given dh, all
    ``[B, S, C]`` f32:

        g_t = dh_t + a_{t+1} g_{t+1}     (a_S := 0)
        db_t = g_t
        dlog_a_t = g_t a_t h_{t-1}      (h_{-1} := 0)

    ``g`` is ``scan`` on the time-reversed operands with log_a shifted one
    step and -inf at the end (exp(-inf) = 0 exactly)."""
    nxt = torch.cat([log_a[:, 1:], torch.full_like(log_a[:, :1],
                                                   float("-inf"))], dim=1)
    g = torch.flip(scan(torch.flip(nxt, [1]),
                        torch.flip(dh.float(), [1])), [1])
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * torch.exp(log_a) * h_prev, g


class LRUScan(torch.autograd.Function):
    """``scan(log_a, b)`` forward (the kernel on the card; a test may pass
    ``lru_ref``), :func:`lru_adjoint` on the same ``scan`` backward."""

    @staticmethod
    def forward(ctx, log_a, b, scan):
        h = scan(log_a, b)
        ctx.save_for_backward(log_a, h)
        ctx.scan = scan
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h = ctx.saved_tensors
        dlog_a, db = lru_adjoint(log_a, h, dh, ctx.scan)
        return dlog_a, db, None


def _launch(log_a, b):
    out = _k.rglru_scan(log_a, b)
    launches["rglru_scan"] += 1
    return out


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _scan_op(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lru(log_a, b).clone()


@_scan_op.register_fake
def _(log_a, b):
    return torch.empty(b.shape, dtype=torch.float32, device=b.device)


counts.register_formula("repro_torch::rglru_scan", lambda *args: 0.0)


def lru(log_a, b):
    """log_a, b: [B, S, C] -> h [B, S, C] f32."""
    dev = b.device
    if counts.is_fake(b):
        check_operands(log_a, b)
        log_a, b = log_a.float(), b.float()
        if torch.is_grad_enabled() and (log_a.requires_grad
                                        or b.requires_grad):
            return LRUScan.apply(log_a, b, _scan_op)
        return _scan_op(log_a, b)
    if log_a.device != dev:
        raise ValueError(f"rglru_scan: operands on several devices "
                         f"{log_a.device}, {dev}")
    # converted only where needed: each call is host time on short prompts
    if not (log_a.dtype is torch.float32 and log_a.is_contiguous()):
        log_a = log_a.float().contiguous()
    if not (b.dtype is torch.float32 and b.is_contiguous()):
        b = b.float().contiguous()
    if dev.type == "cpu":
        check_operands(log_a, b)
        return lru_ref(log_a, b)
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {dev}")
    if torch.is_grad_enabled() and (log_a.requires_grad or b.requires_grad):
        return LRUScan.apply(log_a, b, _launch)
    return _launch(log_a, b)
