"""Median, over every request whose first token came in the window, of
its submit -> first token on the host."""
import numpy as np


def read(run):
    t = run.window.ttft_s()
    return float(np.percentile(t, 50) * 1e3) if t.size else None
