"""Kernel launches a step inside the port's `train.step` span, on any
thread (the backward launches from the autograd engine's): runtime and
driver calls named *LaunchKernel*, a cudaGraphLaunch counted once."""

LAYER = "train step (dist.train_step)"
UNIT = "launches"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.spans import calls_per_span, launches

    return calls_per_span(r.trace, "train.step", launches(r.trace)) if r.units else None
