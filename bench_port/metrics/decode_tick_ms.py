"""Host time from ``on_decode`` to ``on_tick`` (the tick and its tokens
read back), summed over the window's ticks, over the number of ticks."""


def read(run):
    ticks = [s.decode for s in run.window.steps if s.decode is not None]
    if not ticks:
        return None
    return sum(b - a for a, b, _ in ticks) / len(ticks) * 1e3
