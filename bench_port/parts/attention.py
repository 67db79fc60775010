"""Attention: the q, k, v and output projections, and ``QK^T`` and ``PV``
over the positions the token reads (at most a local layer's window)."""
import numpy as np

from bench_port import counts


def flops(cfg, context):
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = counts.window_of(cfg)
    if window:
        context = np.minimum(context, window)
    return 2.0 * cfg.d_model * hd * (2 * h + 2 * k) + 4.0 * context * h * hd
