"""99th percentile of PDHG iterations (``PDHGResult.iters``) over every
instance of the traced passes."""
import numpy as np


def read(data):
    iters = data.get("iters_traced")
    if iters is None or not len(iters):
        return None
    return float(np.percentile(iters, 99))
