"""device_idle.eval: the share of the traced steady window in which no
device operation ran."""

from rrbench import trace


def read(r):
    tr = r.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / trace.window_s(tr))
