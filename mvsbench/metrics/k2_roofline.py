"""K2's share of its roofline: the least time of the warp gathers of a
train step (work.k2_k3_work, every stage and source view) over the device
time a step of the kernels named warp_gather_kernel."""

LAYER = "kernels (kernels.warp_correlate, warp_vjp, sinkhorn_ot)"
UNIT = "%"
MOVES = "train_step_ms"


def read(r):
    return r.roofline_pct("k2", lambda name: "warp_gather_kernel" in name)
