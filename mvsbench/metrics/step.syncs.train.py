"""Host-blocking runtime calls a step (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy) inside the port's
`train.h2d` and `train.step` spans, on any thread."""

LAYER = "train step (dist.train_step)"
UNIT = "syncs"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.spans import calls_per_span, syncs

    if not r.units:
        return None
    calls = syncs(r.trace)
    h2d, step = (calls_per_span(r.trace, name, calls) for name in ("train.h2d", "train.step"))
    return None if h2d is None or step is None else h2d + step
