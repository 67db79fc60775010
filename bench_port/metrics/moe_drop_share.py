"""The MoE's dropped (token, choice) pairs over all its pairs, every MoE
call in the profiled slice (the port's ``moe.dropped_pairs`` and
``moe.pairs`` counters), in %."""
from bench_port import spanview


def read(run):
    v = spanview.load(run)
    if v is None or v.counters.get("moe.pairs", 0) <= 0:
        return None
    return 100.0 * v.counters.get("moe.dropped_pairs", 0.0) \
        / v.counters["moe.pairs"]
