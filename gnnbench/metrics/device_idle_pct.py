"""Share of the traced window in which no kernel, copy or set ran on the
device (``trace.Trace``: the union of their intervals)."""


def read(record):
    tr = record["trace"]
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
