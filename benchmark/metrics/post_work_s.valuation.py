"""Seconds a fan-out of per-case post-processing (`post_work_s`: the
`post_case` spans, those overlapping the dispatch included, summed over
threads): the mean of the program's
`Result.phase_seconds["post_work_s"]` over the window's fan-outs that were
not profiled, or nothing where the program has no such key."""
import numpy as np

KEY = "post_work_s"


def read(data):
    vals = [f["phase_seconds"][KEY] for f in data.get("fanouts", ())
            if not f.get("profiled") and KEY in f["phase_seconds"]]
    return float(np.mean(vals)) if vals else None
