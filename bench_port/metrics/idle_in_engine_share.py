"""The share of the profiled slice in which no device operation ran and
the host was inside ``ServingEngine.step`` (the ``engine.step`` span) but
outside every model call, in %.  ``idle_share`` less this and
``idle_in_model_share`` is the host outside the engine: the client loop."""
from bench_port import spanview


def read(run):
    v = spanview.load(run)
    if v is None or run.slice.busy_s() <= 0:
        return None
    return 100.0 * spanview.idle_split(run, v)["engine"] / run.slice.seconds
