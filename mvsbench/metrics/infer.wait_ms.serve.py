"""Host ms a view in the port's `infer.wait` span: infer_views' wait on
the event behind a chunk's outputs' copy to the host."""

LAYER = "serving driver (tools.test.infer_views)"
UNIT = "ms"
MOVES = "views_per_s"


def read(r):
    from mvsbench.spans import host_ms

    ms = host_ms(r.trace, "infer.wait") if r.units else None
    return None if ms is None else ms / r.cell.traffic["batch"]
