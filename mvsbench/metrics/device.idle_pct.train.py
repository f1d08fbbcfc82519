"""The share of the traced window in which no device operation runs, on
rank 0 under data parallelism."""

LAYER = "device"
UNIT = "%"
MOVES = "train_step_ms"


def read(r):
    if not r.units or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
