"""Process start -> window open: imports, weights, the first build of
the kernels, warm-up and the closed loop's ramp."""


def read(run):
    return run.setup_s
