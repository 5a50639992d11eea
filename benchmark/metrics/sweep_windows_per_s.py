"""Window LPs solved a second: every instance of every whole pass, over
the time from the window's start to the end of the last pass (host
clock; passes run back to back, the last one may overrun and counts)."""


def read(data):
    passes = data.get("passes")
    if not passes:
        return None
    return sum(n for _, _, n in passes) / (passes[-1][1] - data["t_window"])
