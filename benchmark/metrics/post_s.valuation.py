"""Seconds a fan-out of certification and post-processing left after the
dispatch (`post_s`; post work that overlaps the dispatch is not in it):
the mean of the program's `Result.phase_seconds["post_s"]` over the
window's fan-outs that were not profiled."""
import numpy as np

KEY = "post_s"


def read(data):
    vals = [f["phase_seconds"][KEY] for f in data.get("fanouts", ())
            if not f.get("profiled") and KEY in f["phase_seconds"]]
    return float(np.mean(vals)) if vals else None
