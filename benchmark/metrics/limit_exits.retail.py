"""Instances a fan-out's first solves left at the iteration limit
unconverged (the solve ledger's ``at_limit``, summed over the groups'
first solves, before any rung of the escalation ladder): the mean over
the window's fan-outs that were not profiled, or nothing where the
program's ledger has no such count."""
import numpy as np


def read(data):
    vals = [f["limit_exits"] for f in data.get("fanouts", ())
            if not f.get("profiled") and f.get("limit_exits") is not None]
    return float(np.mean(vals)) if vals else None
