"""Seconds a fan-out of float64 certification (`certify_s`: the
`certify` spans, the groups' pass and the ladder's re-certification,
summed over threads): the mean of the program's
`Result.phase_seconds["certify_s"]` over the window's fan-outs that were
not profiled, or nothing where the program has no such key."""
import numpy as np

KEY = "certify_s"


def read(data):
    vals = [f["phase_seconds"][KEY] for f in data.get("fanouts", ())
            if not f.get("profiled") and KEY in f["phase_seconds"]]
    return float(np.mean(vals)) if vals else None
