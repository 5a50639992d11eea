"""Share of the traced passes with nothing running on the device:
1 - (union of device activity intervals) / the slice's length."""


def read(data):
    tr = data.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
