"""Host ms a traced step spends inside the train_step callable: the
enqueue of its forward, backward and update, and its waits on the card."""

LAYER = "train step (dist.train_step)"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    steps = r.host.get("step")
    return 1e3 * sum(steps) / len(steps) if steps else None
