"""Host ms a view in the port's `infer.h2d` span: the stack, pin and
non-blocking copy of a chunk's inputs in tools.test.infer_views."""

LAYER = "serving driver (tools.test.infer_views)"
UNIT = "ms"
MOVES = "views_per_s"


def read(r):
    from mvsbench.spans import host_ms

    ms = host_ms(r.trace, "infer.h2d") if r.units else None
    return None if ms is None else ms / r.cell.traffic["batch"]
