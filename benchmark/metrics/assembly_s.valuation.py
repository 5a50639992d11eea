"""Seconds a fan-out of host LP assembly of the case model
(`dispatch_assembly_s`): the mean of the program's
`Result.phase_seconds["dispatch_assembly_s"]` over the window's fan-outs
that were not profiled."""
import numpy as np

KEY = "dispatch_assembly_s"


def read(data):
    vals = [f["phase_seconds"][KEY] for f in data.get("fanouts", ())
            if not f.get("profiled") and KEY in f["phase_seconds"]]
    return float(np.mean(vals)) if vals else None
