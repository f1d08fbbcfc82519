"""The train step's share of the card's float32 peak: the plain
reference's FLOPs for a step's forward, loss and backward at the cell's
shapes a rank (FlopCounterMode), over the traced window's seconds a step,
over 67 TFLOP/s."""

LAYER = "whole train step"
UNIT = "%"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.work import F32_FLOP_PER_S

    unit_s = r.unit_s()
    if not unit_s:
        return None
    return 100.0 * r.flops / unit_s / F32_FLOP_PER_S
