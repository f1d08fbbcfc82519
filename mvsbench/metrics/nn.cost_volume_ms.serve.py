"""Device ms a view of the kernels launched inside the port's
`mvs.cost_volume` spans (one a stage): K1 and its geometry glue."""

LAYER = "cost volume (kernels.cost_volume)"
UNIT = "ms"
MOVES = "views_per_s"


def read(r):
    s = r.per_unit_s(lambda name: True, "mvs.cost_volume")
    return None if s is None else s * 1e3 / r.cell.traffic["batch"]
