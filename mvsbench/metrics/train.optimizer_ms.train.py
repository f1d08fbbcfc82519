"""Host ms a step in the port's `train.optimizer` span: Adam's step and
the learning-rate schedule's."""

LAYER = "train step (dist.train_step)"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.spans import host_ms

    return host_ms(r.trace, "train.optimizer") if r.units else None
