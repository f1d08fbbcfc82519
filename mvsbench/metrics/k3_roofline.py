"""K3's share of its roofline: the least time of the warp gradient
scatters of a train step (work.k2_k3_work) over the device time a step of
the kernels named warp_scatter_kernel."""

LAYER = "kernels (kernels.warp_correlate, warp_vjp, sinkhorn_ot)"
UNIT = "%"
MOVES = "train_step_ms"


def read(r):
    return r.roofline_pct("k3", lambda name: "warp_scatter_kernel" in name)
