"""K1's share of its roofline: the least time of the fused cost volume at
the cell's four stages (work.k1_work at 3.35 TB/s and 67 TFLOP/s) over the
device time a forward of the kernels named warp_correlate_kernel."""

from mvsbench import work

LAYER = "kernels (kernels.warp_correlate, warp_vjp, sinkhorn_ot)"
UNIT = "%"
MOVES = "views_per_s"


def least_s(cell):
    """Least seconds a unit of this cell's traffic (work.least_seconds)."""
    t = cell.traffic
    shapes = work.stage_shapes(t["height"], t["width"], cell.ref_config)
    return work.least_seconds("k1", shapes, t["batch"], t["views"])


def read(r):
    return r.roofline_pct(least_s(r.cell), lambda name: "warp_correlate_kernel" in name)
