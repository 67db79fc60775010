"""Plain f32 reference of the ``ssm`` family (Mamba2 with SSD,
arXiv:2405.21060), as the configuration states it.  A layer:

    u = RMSNorm(x);  [z | xBC | dt] = u @ in_proj
    xBC = silu(causal depthwise conv of width W over xBC, + bias)
    [xs | B | C] = xBC;  dt = softplus(dt + dt_bias);  A = -exp(a_log)
    state_t = exp(dt_t A_h) state_{t-1} + dt_t xs_t B_t^T   (per head h)
    y_t = state_t C_t + D_h xs_t
    x = x + RMSNorm(y * silu(z)) @ out_proj

with one B/C group for all heads.  The recurrence is evaluated exactly in
chunks of ``CHUNK`` steps (within a chunk as the sum of its terms, across
chunks by carrying the state), all in f32.  The model is causal with no
batch-dependent step, so one pass over the prompt and the served tokens
gives the logits that a prefill and then one decode step a token give.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.plain import logits, matmul, rmsnorm

CHUNK = 128


def ssd(x, dt, a, b, c, q: int = CHUNK):
    """x [S, H, P], dt [S, H], a [H] (negative), b and c [S, N] -> y
    [S, H, P] of the recurrence above, from a zero state."""
    s, h, p = x.shape
    n = b.shape[-1]
    pad = -s % q
    if pad:                       # dt = 0, x = 0: no decay, no update
        x = torch.cat([x, x.new_zeros((pad, h, p))])
        dt = torch.cat([dt, dt.new_zeros((pad, h))])
        b = torch.cat([b, b.new_zeros((pad, n))])
        c = torch.cat([c, c.new_zeros((pad, n))])
    nc = x.shape[0] // q
    cum = torch.cumsum((dt * a).reshape(nc, q, h), dim=1)        # [c,q,H]
    xdt = (x * dt[..., None]).reshape(nc, q, h, p)
    bc, cc = b.reshape(nc, q, n), c.reshape(nc, q, n)
    diff = cum[:, :, None, :] - cum[:, None, :, :]               # [c,i,j,H]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(diff.masked_fill(~causal[None, :, :, None],
                                       float("-inf")))
    cb = torch.einsum("cin,cjn->cij", cc, bc)
    y = torch.einsum("cijh,cjhp->cihp", cb[..., None] * decay, xdt)
    to_end = torch.exp(cum[:, -1:, :] - cum)                     # [c,q,H]
    chunk_states = torch.einsum("cjn,cjh,cjhp->chpn", bc, to_end, xdt)
    state = x.new_zeros((h, p, n))
    before = []
    for i in range(nc):
        before.append(state)
        state = torch.exp(cum[i, -1])[:, None, None] * state \
            + chunk_states[i]
    before = torch.stack(before)                                 # [c,H,P,N]
    y = y + torch.einsum("cin,cih,chpn->cihp", cc, torch.exp(cum), before)
    return y.reshape(nc * q, h, p)[:s]


def conv(xbc, w, bias):
    """Causal depthwise conv: out_t = sum_i x_{t-W+1+i} w_i + bias."""
    width = w.shape[0]
    xp = torch.cat([xbc.new_zeros((width - 1, xbc.shape[1])), xbc])
    out = bias.float().expand_as(xbc).clone()
    for i in range(width):
        out = out + xp[i:i + xbc.shape[0]] * w[i].float()
    return out


def served_logits(weights, m, prompt, served, prec: str = "f32"):
    """Logits [n, vocab] f32 at the positions that produced the ``n``
    served tokens, teacher-forced on ``prompt`` [T] and ``served`` [n]."""
    tokens = torch.cat([prompt, served[:-1]]).long()
    t = prompt.shape[0]
    di = m["ssm_expand"] * m["d_model"]
    n, p = m["ssm_state"], m["ssm_head_dim"]
    h = di // p
    eps = m["norm_eps"]
    x = weights["embedding"]["embed"][tokens].float()
    for i in range(m["num_layers"]):
        lp = weights["blocks"][f"layer_{i:02d}"]
        w = lp["ssm"]
        u = rmsnorm(x, lp["ln1"]["scale"], eps)
        z, xbc, dt = torch.split(matmul(u, w["in_proj"], prec),
                                 [di, di + 2 * n, h], dim=-1)
        xbc = F.silu(conv(xbc, w["conv_w"], w["conv_b"]))
        xs, b, c = torch.split(xbc, [di, n, n], dim=-1)
        xs = xs.reshape(-1, h, p)
        dt = F.softplus(dt + w["dt_bias"].float())
        y = ssd(xs, dt, -torch.exp(w["a_log"].float()), b, c)
        y = y + w["d_skip"].float()[None, :, None] * xs
        y = y.reshape(-1, di) * F.silu(z)
        y = rmsnorm(y, w["norm_scale"], eps)
        x = x + matmul(y, w["out_proj"], prec)
    x = rmsnorm(x[t - 1:], weights["final_norm"]["scale"], eps)
    return logits(x, weights, m, prec)
