"""90th percentile of the wall time of every pass in the window, from its
draw to its last result synchronised (host clock)."""
import numpy as np


def read(data):
    passes = data.get("passes")
    if not passes:
        return None
    return float(np.percentile([t1 - t0 for t0, t1, _ in passes], 90))
