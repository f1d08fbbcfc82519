"""Device ms a step of the kernels whose name holds `wgrad`: cuDNN's
weight-gradient engines and K6's (conv_wgrad_*), launched in the step."""

LAYER = "Reg2d (nn.reg)"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    s = r.per_unit_s(lambda name: "wgrad" in name)
    return None if s is None else s * 1e3
