"""Host ms a step in the port's `train.forward` span: the enqueue of the
model call in dist.train_step._forward_loss."""

LAYER = "train step (dist.train_step)"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.spans import host_ms

    return host_ms(r.trace, "train.forward") if r.units else None
