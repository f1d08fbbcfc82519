"""Host ms a step in the port's `train.h2d` span: train.loop.device_batch's
copies of a batch to the card (pageable, each waiting for the stream)."""

LAYER = "training driver (train.loop, data.loader)"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.spans import host_ms

    return host_ms(r.trace, "train.h2d") if r.units else None
