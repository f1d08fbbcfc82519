"""Host ms a view in the port's `infer.forward` span: the enqueue of the
eval forward and of its outputs' copies to the host behind it."""

LAYER = "whole eval forward"
UNIT = "ms"
MOVES = "views_per_s"


def read(r):
    from mvsbench.spans import host_ms

    ms = host_ms(r.trace, "infer.forward") if r.units else None
    return None if ms is None else ms / r.cell.traffic["batch"]
