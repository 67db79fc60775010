"""95th percentile of every gap between consecutive tokens of a request
whose later token came in the window (a gap holds whatever prefills the
engine ran in between).  A per-layer reading: its tail rests on the
spread of the mix's lengths, which no source states."""
import numpy as np


def read(run):
    g = run.window.gaps_s()
    return float(np.percentile(g, 95) * 1e3) if g.size else None
