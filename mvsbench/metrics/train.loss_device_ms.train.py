"""Device ms a step of the kernels launched inside the port's `train.loss`
span: the loss's forward (the plain Sinkhorn iterations with --ot_backend
xla, K4 and its glue with pallas); its backward runs in train.backward."""

LAYER = "loss (models.losses)"
UNIT = "ms"
MOVES = "train_step_ms"


def read(r):
    s = r.per_unit_s(lambda name: True, "train.loss")
    return None if s is None else s * 1e3
