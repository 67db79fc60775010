"""Model FLOPs of every prefilled and decoded token in the window (the
benchmark's own count, ``counts.py``, by the cell's configuration file's
layer parts), over the window's length times the card's dense bf16 peak,
in %."""
from bench_port import counts


def read(run):
    config = run.cell.config
    flops = 0.0
    for s in run.window.steps:
        for _, _, n in s.prefills:
            flops += counts.prefill_flops(run.cfg, n, config)
        if s.decode is not None:
            flops += sum(counts.decode_flops(run.cfg, p, config)
                         for p in s.decode[2])
    return 100.0 * flops / (run.window.seconds * counts.PEAK_BF16)
