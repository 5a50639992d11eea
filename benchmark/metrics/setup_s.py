"""Set-up: from process start to the window's start (host clock)."""


def read(data):
    return data.get("setup_s")
