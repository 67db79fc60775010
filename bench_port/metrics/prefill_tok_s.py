"""Prompt tokens over the host time inside prefills in the window (each
from its step's start, or the previous prefill's first token, to its own
first token, ``on_prefill``)."""


def read(run):
    pf = [p for s in run.window.steps for p in s.prefills]
    busy = sum(end - begin for begin, end, _ in pf)
    return sum(n for _, _, n in pf) / busy if busy > 0 else None
