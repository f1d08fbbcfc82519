"""K3's share of its roofline: the least time of the warp gradient
scatters of a train step (work.k2_k3_work) over the device time a step of
the kernels named warp_scatter_kernel."""

from mvsbench import work

LAYER = "kernels (kernels.warp_correlate, warp_vjp, sinkhorn_ot)"
UNIT = "%"
MOVES = "train_step_ms"


def least_s(cell):
    """Least seconds a unit of this cell's traffic (work.least_seconds)."""
    t = cell.traffic
    shapes = work.stage_shapes(t["height"], t["width"], cell.ref_config)
    return work.least_seconds("k3", shapes, t["batch"], t["views"])


def read(r):
    return r.roofline_pct(least_s(r.cell), lambda name: "warp_scatter_kernel" in name)
