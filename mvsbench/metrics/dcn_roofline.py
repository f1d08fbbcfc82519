"""The deformable heads' share of their roofline: their least time a
forward at the cell's shapes over the device time a forward of the kernels
launched in the port's `mvs.dcn` spans (nn.dcn_ms.serve's).

Per head of C channels at h x w over N = views x batch images (FPN4's
outputs: C = 8b, 4b, 2b, b at strides 8, 4, 2, 1), the least time is
max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s) with bytes = 2 x 4 C N h w (the
input read, the output written) and FLOPs = N h w (2 x 27 x 9C, the offset
and modulation convs' 27 outputs; 2 x 9C x C, the contraction; 72 C, four
corners' bilinear weights and products and the modulation a tap and
channel)."""

from mvsbench import work

LAYER = "DCN heads (nn.dcn)"
UNIT = "%"
MOVES = "views_per_s"


def least_s(cell):
    """Least seconds a unit (a forward of `batch` reference views)."""
    t = cell.traffic
    n = t["views"] * t["batch"]
    total = 0.0
    for h, w, c, _, _ in work.stage_shapes(t["height"], t["width"], cell.ref_config):
        pixels = n * h * w
        total += work.bound_s(2 * 4 * c * pixels,
                              pixels * (2 * 27 * 9 * c + 2 * 9 * c * c + 72 * c))
    return total


def read(r):
    s = r.per_unit_s(lambda name: True, "mvs.dcn")
    return None if s is None else 100.0 * least_s(r.cell) / s
