"""Plain PyTorch oracle of the Mamba2 SSD scan — port of
:mod:`repro.kernels.ssd_scan.ref`: the sequential recurrence

    state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * x_t B_t^T   ([P, N])
    y_t     = state_t . C_t                     (D x_t added by the caller)

with A_h = -exp(a_log_h), evaluated step by step.  It takes any sequence
length and an optional initial state.  The CUDA kernel
(``repro_torch/csrc/ssd_scan.cu``) and the model's chunked closed form
(:func:`repro_torch.models.ssm.ssd_chunked`, the wrapper's CPU path)
compute the same function, up to rounding.
"""
from __future__ import annotations

import torch


def check_operands(x, dt, b, c, a_log, init_state=None) -> None:
    """Raise ``ValueError`` unless x ``[B,S,H,P]``, dt ``[B,S,H]``, b and c
    ``[B,S,N]``, a_log ``[H]`` and the initial state ``[B,H,P,N]`` (if
    given) fit together."""
    if x.ndim != 4:
        raise ValueError(f"ssd_scan: want x [B, S, H, P], got "
                         f"{tuple(x.shape)}")
    bsz, s, h, _ = x.shape
    if tuple(dt.shape) != (bsz, s, h):
        raise ValueError(f"ssd_scan: want dt [B, S, H] = {(bsz, s, h)}, "
                         f"got {tuple(dt.shape)}")
    if b.ndim != 3 or tuple(b.shape[:2]) != (bsz, s) \
            or b.shape != c.shape:
        raise ValueError(f"ssd_scan: want b, c [B, S, N] of one shape "
                         f"(one group), got {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if tuple(a_log.shape) != (h,):
        raise ValueError(f"ssd_scan: want a_log [H] = ({h},), got "
                         f"{tuple(a_log.shape)}")
    want = (bsz, h, x.shape[3], b.shape[2])
    if init_state is not None and tuple(init_state.shape) != want:
        raise ValueError(f"ssd_scan: want init_state [B, H, P, N] = {want}, "
                         f"got {tuple(init_state.shape)}")


def ssd_ref(x, dt, b, c, a_log, init_state=None):
    """x: [B,S,H,P]; dt: [B,S,H]; b, c: [B,S,N]; a_log: [H]
    -> (y [B,S,H,P], final_state [B,H,P,N]), both f32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)                      # [B, H]
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           bf[:, t])
        state = decay[..., None, None] * state + upd
        y[:, t] = torch.einsum("bhpn,bn->bhp", state, cf[:, t])
    return y, state
