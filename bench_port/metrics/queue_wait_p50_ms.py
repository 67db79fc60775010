"""Median wait in the engine's queue, in ms: from a request's
``engine.submit`` mark to the start of its ``engine.admit`` span, over
the requests whose mark and span both lie in the profiled slice."""
import statistics

from bench_port import spanview


def read(run):
    v = spanview.load(run)
    if v is None:
        return None
    submitted = {v.rid[i]: v.t0[i] for i in v.named("engine.submit")}
    waits = [v.t0[i] - submitted[v.rid[i]] for i in v.named("engine.admit")
             if v.rid[i] in submitted]
    return 1e3 * statistics.median(waits) if waits else None
