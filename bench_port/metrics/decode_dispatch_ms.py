"""Mean host time inside ``Model.decode_step`` (the ``model.decode_step``
span) a tick in the profiled slice, in ms: the tick's enqueue, with the
waits of the hidden syncs inside it."""
from bench_port import spanview


def read(run):
    v = spanview.load(run)
    if v is None:
        return None
    ticks = v.intervals("model.decode_step")
    if not ticks:
        return None
    return 1e3 * spanview.length(ticks) / len(ticks)
