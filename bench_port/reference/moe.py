"""Plain f32 reference of the ``moe`` family (OLMoE-style decoder): RMSNorm,
GQA attention with RoPE and a causal mask, and a top-k mixture of gated
(SwiGLU) experts after a softmax router, as the configuration states it:

* the router is a softmax over ``x @ router`` in f32; a token takes its
  ``experts_per_token`` most probable experts (the lower index first among
  equal ones) and weighs them by their probabilities renormalised to one;
* a forward over ``T`` tokens gives each expert ``max(8, int(T * k *
  capacity_factor / E))`` slots, filled by (token, choice) pairs in token
  order; a pair past its expert's capacity adds nothing.

A served request's tokens are the prompt, prefilled as one forward of its
``T`` tokens (the capacity above), then one token a decode step.  The
reference runs the prompt and the served tokens in one causal pass: the
prompt's rows share the prompt's capacity, and each decoded row is routed
on its own (one token's ``k`` pairs never fill 8 slots).  The engine
decodes a batch of slots at once, with the capacity of the batch; the
reference does not know the batch, so it holds every decoded token to its
own routing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.reference.plain import logits, matmul, rmsnorm, rope


def attention(q, k, v, block: int = 1024):
    """Causal attention, q [S, H, hd], k and v [S, K, hd] (query head h
    reads KV head ``h // (H / K)``), in blocks of query rows."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    cols = torch.arange(s, device=q.device)
    for r0 in range(0, s, block):
        r1 = min(s, r0 + block)
        sc = torch.einsum("qhd,khd->hqk", q[r0:r1], k[:r1]) / hd ** 0.5
        rows = torch.arange(r0, r1, device=q.device)
        sc = sc.masked_fill(cols[None, None, :r1] > rows[None, :, None],
                            float("-inf"))
        out[r0:r1] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:r1])
    return out


def capacity_keep(top_e, num_experts: int, cap: int):
    """top_e [T, k] -> keep [T, k]: a (token, choice) pair keeps its
    expert's slot if fewer than ``cap`` earlier pairs (in token order,
    then choice order) chose that expert."""
    t, k = top_e.shape
    onehot = F.one_hot(top_e.reshape(-1), num_experts)
    before = torch.cumsum(onehot, dim=0) - onehot
    pos = before.gather(1, top_e.reshape(-1, 1))[:, 0]
    return (pos < cap).reshape(t, k)


def moe(h, p, m, prompt_len: int, prec: str):
    """The expert layer on ``h`` [S, d]: rows below ``prompt_len`` share
    one capacity, later rows are routed alone."""
    s, d = h.shape
    e, k = m["num_experts"], m["experts_per_token"]
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    top_e = torch.sort(probs, dim=-1, descending=True,
                       stable=True)[1][:, :k]
    top_p = torch.gather(probs, 1, top_e)
    w = top_p / top_p.sum(-1, keepdim=True)
    keep = torch.ones_like(top_e, dtype=torch.bool)
    t = prompt_len
    cap = max(8, int(t * k * m["moe_capacity_factor"] / e))
    keep[:t] = capacity_keep(top_e[:t], e, cap)
    out = torch.zeros((s, d), dtype=torch.float32, device=h.device)
    for x in range(e):
        tok, slot = torch.nonzero((top_e == x) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        y = F.silu(matmul(xe, p["wg"][x], prec)) * matmul(xe, p["wi"][x],
                                                         prec)
        y = matmul(y, p["wo"][x], prec)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def served_logits(weights, m, prompt, served, prec: str = "f32"):
    """Logits [n, vocab] f32 at the positions that produced the ``n``
    served tokens (the prompt's last, then each served token but the
    last), teacher-forced on ``prompt`` [T] and ``served`` [n]."""
    tokens = torch.cat([prompt, served[:-1]]).long()
    s, t = tokens.shape[0], prompt.shape[0]
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    eps = m["norm_eps"]
    pos = torch.arange(s, device=tokens.device)
    x = weights["embedding"]["embed"][tokens].float()
    for i in range(m["num_layers"]):
        lp = weights["blocks"][f"layer_{i:02d}"]
        a = lp["attn"]
        y = rmsnorm(x, lp["ln1"]["scale"], eps)
        q = matmul(y, a["wq"].reshape(d, h * hd), prec).reshape(s, h, hd)
        k = matmul(y, a["wk"].reshape(d, kv * hd), prec).reshape(s, kv, hd)
        v = matmul(y, a["wv"].reshape(d, kv * hd), prec).reshape(s, kv, hd)
        q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
        o = attention(q, k, v).reshape(s, h * hd)
        x = x + matmul(o, a["wo"].reshape(h * hd, d), prec)
        y = rmsnorm(x, lp["ln2"]["scale"], eps)
        x = x + moe(y, lp["moe"], m, t, prec)
    x = rmsnorm(x[t - 1:], weights["final_norm"]["scale"], eps)
    return logits(x, weights, m, prec)
