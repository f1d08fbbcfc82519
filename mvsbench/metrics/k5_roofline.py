"""K5's share of its roofline: the least time of the Sinkhorn backward of
a train step (work.ot_work) over the device time a step of the kernels
named sinkhorn_bwd_*; nothing to read where the loss runs the plain
iterations."""

LAYER = "kernels (kernels.warp_correlate, warp_vjp, sinkhorn_ot)"
UNIT = "%"
MOVES = "train_step_ms"


def read(r):
    return r.roofline_pct("k5", lambda name: "sinkhorn_bwd_" in name)
