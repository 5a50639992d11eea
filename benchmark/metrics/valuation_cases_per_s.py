"""Sensitivity cases valued a second: every case of every whole fan-out,
over the time from the window's start to the end of the last fan-out
(host clock; the last one may overrun and counts)."""


def read(data):
    fanouts = data.get("fanouts")
    if not fanouts:
        return None
    return (sum(f["cases"] for f in fanouts)
            / (fanouts[-1]["t1"] - data["t_window"]))
