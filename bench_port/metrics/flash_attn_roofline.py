"""The flash-attention kernel's share of its roofline in the profiled
slice: the bound of every prefill's layers that have the ``attention``
part (causal, the prompt's length, a local layer's window;
``counts.flash_attn_bound_s``) over the device time of the
``flash_fwd_kernel`` kernels, in %."""
from bench_port import counts


def read(run):
    if run.slice is None:
        return None
    spent = run.slice.by_kind().get("flash_attention_fwd", 0.0)
    cfg = run.cfg
    layers = counts.layers_with(cfg, "attention", run.cell.config)
    bound = sum(layers * counts.flash_attn_bound_s(
        n, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        counts.window_of(cfg))
        for s in run.slice_steps for _, _, n in s.prefills)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
