"""The traced fan-out's solves on the card against their roofline: the
least time the card could take for the work they needed (``roofline.py``,
counted from each group's LP, K by its non-zeros, and its instances'
iterations, as the solve ledger gives them; the first solves and the
escalation ladder's retries alike) over the device time of the solver's
kernels in the traced slice (the chunk, check and status kernels,
overlaps counted once).  Nothing where the ledger lacks the
LPs' non-zeros or the iterations, or the trace has no such kernel."""
from benchmark import roofline


def read(data):
    tr, work = data.get("trace"), data.get("solve_work")
    if not tr or not work or not tr.get("kernel_s"):
        return None
    return 100.0 * roofline.bound_s(*work) / tr["kernel_s"]
