"""Mean number of active slots a decode tick in the window (the
``on_decode`` hook's positions)."""


def read(run):
    sizes = [len(s.decode[2]) for s in run.window.steps
             if s.decode is not None]
    return sum(sizes) / len(sizes) if sizes else None
