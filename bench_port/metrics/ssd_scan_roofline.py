"""The SSD scan's share of its roofline in the profiled slice: the bound
of every prefill's layers that have the ``ssd`` part (the prompt's
length, no initial state; ``counts.ssd_scan_bound_s``) over the device
time of the ``ssd_scan_*`` kernels, in %."""
from bench_port import counts


def read(run):
    if run.slice is None:
        return None
    spent = run.slice.by_kind().get("ssd_scan", 0.0)
    cfg = run.cfg
    layers = counts.layers_with(cfg, "ssd", run.cell.config)
    bound = sum(layers * counts.ssd_scan_bound_s(
        n, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        for s in run.slice_steps for _, _, n in s.prefills)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
