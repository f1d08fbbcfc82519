"""Device ms a view of the kernels launched inside model.feature's range
(a forward hook pair on the FPN)."""

LAYER = "FPN (nn.fpn)"
UNIT = "ms"
MOVES = "views_per_s"


def read(r):
    s = r.per_unit_s(lambda name: True, "model.feature")
    return None if s is None else s * 1e3 / r.cell.traffic["batch"]
