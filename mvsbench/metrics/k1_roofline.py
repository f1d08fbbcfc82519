"""K1's share of its roofline: the least time of the fused cost volume at
the cell's four stages (work.k1_work at 3.35 TB/s and 67 TFLOP/s) over the
device time a forward of the kernels named warp_correlate_kernel."""

LAYER = "kernels (kernels.warp_correlate, warp_vjp, sinkhorn_ot)"
UNIT = "%"
MOVES = "views_per_s"


def read(r):
    return r.roofline_pct("k1", lambda name: "warp_correlate_kernel" in name)
