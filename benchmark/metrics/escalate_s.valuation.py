"""Seconds a fan-out of the escalation ladder (`escalate_s`: the
`escalate` spans, one a rung of a group, summed over threads): the mean of the program's
`Result.phase_seconds["escalate_s"]` over the window's fan-outs that were
not profiled, or nothing where the program has no such key."""
import numpy as np

KEY = "escalate_s"


def read(data):
    vals = [f["phase_seconds"][KEY] for f in data.get("fanouts", ())
            if not f.get("profiled") and KEY in f["phase_seconds"]]
    return float(np.mean(vals)) if vals else None
