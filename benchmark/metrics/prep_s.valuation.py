"""Seconds a fan-out of case preparation in the entry (params and
scenarios; `DERVET.solve`'s prep_s): the mean of the program's
`Result.phase_seconds["prep_s"]` over the window's fan-outs that were
not profiled."""
import numpy as np

KEY = "prep_s"


def read(data):
    vals = [f["phase_seconds"][KEY] for f in data.get("fanouts", ())
            if not f.get("profiled") and KEY in f["phase_seconds"]]
    return float(np.mean(vals)) if vals else None
