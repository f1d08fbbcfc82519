"""Host ms a traced step waits in the loader's next() (MVSLoader's
prefetch queue), timed by the loader the harness hands to train_epoch."""

LAYER = "training driver (train.loop, data.loader)"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    waits = r.host.get("input_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
