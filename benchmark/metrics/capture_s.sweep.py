"""Host seconds spent capturing CUDA graphs of check windows
(``SolveStats.capture_s``), summed over the window's solves."""


def read(data):
    return data.get("capture_s")
