"""Seconds a fan-out of the dispatch pipeline's solve time
(`dispatch_solve_s`, summed over its groups): the mean of the program's
`Result.phase_seconds["dispatch_solve_s"]` over the window's fan-outs
that were not profiled."""
import numpy as np

KEY = "dispatch_solve_s"


def read(data):
    vals = [f["phase_seconds"][KEY] for f in data.get("fanouts", ())
            if not f.get("profiled") and KEY in f["phase_seconds"]]
    return float(np.mean(vals)) if vals else None
