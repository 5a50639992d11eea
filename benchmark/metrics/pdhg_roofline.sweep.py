"""The traced passes' solves against their roofline: the least time the
card could take for the work the instances needed (``roofline.py``,
counted from the LPs and the iterations) over the device time under the
solve calls (the union of device activity inside each ``solve`` span)."""
from benchmark import roofline


def read(data):
    tr, work = data.get("trace"), data.get("solve_work")
    if not tr or not work:
        return None
    dev = sum(v for k, v in tr["span_device_s"].items()
              if k.startswith("solve"))
    if dev <= 0:
        return None
    return 100.0 * roofline.bound_s(*work) / dev
