"""Host ms a step in the port's `train.backward` span: the enqueue of the
backward, (loss * scale).backward(), whose launches the autograd engine
makes from its own thread while this one waits."""

LAYER = "train step (dist.train_step)"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.spans import host_ms

    return host_ms(r.trace, "train.backward") if r.units else None
