"""Device ms a view of the kernels launched inside the port's `mvs.dcn`
spans (one a deformable head, four a forward): the offset and modulation
convs, the bilinear taps and the (9C -> C) contraction.  Nothing where the
model has no deformable heads."""

LAYER = "DCN heads (nn.dcn)"
UNIT = "ms"
MOVES = "views_per_s"


def read(r):
    s = r.per_unit_s(lambda name: True, "mvs.dcn")
    return None if s is None else s * 1e3 / r.cell.traffic["batch"]
