"""K5's share of its roofline: the least time of the Sinkhorn backward of
a train step (work.ot_work) over the device time a step of the kernels
named sinkhorn_bwd_*; nothing to read where the loss runs the plain
iterations."""

from mvsbench import work

LAYER = "kernels (kernels.warp_correlate, warp_vjp, sinkhorn_ot)"
UNIT = "%"
MOVES = "train_step_ms"


def least_s(cell):
    """Least seconds a unit of this cell's traffic (work.least_seconds)."""
    t = cell.traffic
    shapes = work.stage_shapes(t["height"], t["width"], cell.ref_config)
    return work.least_seconds("k5", shapes, t["batch"], t["views"],
                              int(cell.config["train"]["ot_iter"]))


def read(r):
    return r.roofline_pct(least_s(r.cell), lambda name: "sinkhorn_bwd_" in name)
