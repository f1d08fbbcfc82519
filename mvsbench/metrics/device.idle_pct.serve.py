"""The share of the traced window in which no device operation runs (one
minus the union of kernel, copy and set intervals over the window)."""

LAYER = "device"
UNIT = "%"
MOVES = "views_per_s"


def read(r):
    if not r.units or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
