"""Device ms a view of the kernels launched inside the model.reg[s]
ranges (a forward hook pair on each stage's regulariser)."""

LAYER = "Reg2d (nn.reg)"
UNIT = "ms"
MOVES = "views_per_s"


def read(r):
    s = r.per_unit_s(lambda name: True, "model.reg")
    return None if s is None else s * 1e3 / r.cell.traffic["batch"]
