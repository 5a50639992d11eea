"""Seconds a fan-out of Reliability's outage walks (`outage_walk_s`:
the `outage_walk` spans, summed over threads): the mean of the program's
`Result.phase_seconds["outage_walk_s"]` over the window's fan-outs that were
not profiled, or nothing where the program has no such key."""
import numpy as np

KEY = "outage_walk_s"


def read(data):
    vals = [f["phase_seconds"][KEY] for f in data.get("fanouts", ())
            if not f.get("profiled") and KEY in f["phase_seconds"]]
    return float(np.mean(vals)) if vals else None
