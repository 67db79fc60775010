"""95th percentile, over every request whose first token came in the
window, of its submit -> first token on the host.  A per-layer reading: its
tail rests on the spread of the mix's lengths, which no source states."""
import numpy as np


def read(run):
    t = run.window.ttft_s()
    return float(np.percentile(t, 95) * 1e3) if t.size else None
