"""The eval forward's share of the card's float32 peak: the plain
reference's FLOPs for one forward at the cell's shapes (FlopCounterMode),
over the traced window's seconds a forward, over 67 TFLOP/s."""

LAYER = "whole eval forward"
UNIT = "%"
MOVES = "views_per_s"


def read(r):
    from mvsbench.work import F32_FLOP_PER_S

    unit_s = r.unit_s()
    if not unit_s:
        return None
    return 100.0 * r.flops / unit_s / F32_FLOP_PER_S
