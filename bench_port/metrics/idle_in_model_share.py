"""The share of the profiled slice in which no device operation ran and
the host was inside a model call (a ``model.prefill`` or
``model.decode_step`` span of the port), in %.  With
``idle_in_engine_share`` and the host outside the engine it splits
``idle_share``."""
from bench_port import spanview


def read(run):
    v = spanview.load(run)
    if v is None or run.slice.busy_s() <= 0:
        return None
    return 100.0 * spanview.idle_split(run, v)["model"] / run.slice.seconds
