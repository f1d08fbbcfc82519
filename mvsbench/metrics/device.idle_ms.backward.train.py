"""Ms a step of the port's `train.backward` span in which no device
operation runs: the span's length less its overlap with the union of
kernel, copy and set intervals."""

LAYER = "device"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.spans import idle_ms

    return idle_ms(r.trace, "train.backward") if r.units else None
