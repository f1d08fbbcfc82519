"""Kernel launches a view inside the port's `infer.forward` span: runtime
and driver calls named *LaunchKernel*, a cudaGraphLaunch counted once."""

LAYER = "whole eval forward"
UNIT = "launches"
MOVES = "views_per_s"


def read(r):
    from mvsbench.spans import calls_per_span, launches

    n = calls_per_span(r.trace, "infer.forward", launches(r.trace)) if r.units else None
    return None if n is None else n / r.cell.traffic["batch"]
