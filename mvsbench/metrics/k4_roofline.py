"""K4's share of its roofline: the least time of the Sinkhorn forward of
a train step's four stages (work.ot_work at the published issue rates and
3.35 TB/s) over the device time a step of the kernels named sinkhorn_fwd_*;
nothing to read where the loss runs the plain iterations."""

LAYER = "kernels (kernels.warp_correlate, warp_vjp, sinkhorn_ot)"
UNIT = "%"
MOVES = "train_step_ms"


def read(r):
    return r.roofline_pct("k4", lambda name: "sinkhorn_fwd_" in name)
