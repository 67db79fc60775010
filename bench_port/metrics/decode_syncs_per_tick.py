"""Host-device synchronisations the port counted inside its decode ticks
(``sync`` marks under an ``engine.decode`` span) in the profiled slice,
over the ticks there."""
from bench_port import spanview


def read(run):
    v = spanview.load(run)
    if v is None:
        return None
    ticks = v.named("engine.decode")
    if not ticks:
        return None
    syncs = sum(v.under(i, "engine.decode") for i in v.named("sync"))
    return syncs / len(ticks)
