"""The share of the profiled slice in which no device operation ran (the
operations' intervals merged), in %."""


def read(run):
    if run.slice is None or run.slice.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s() / run.slice.seconds)
