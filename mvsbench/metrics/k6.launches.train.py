"""Launches a step of K6's main kernel (conv_wgrad_kernel, the planar
convs' weight gradient; its second pass, conv_wgrad_reduce_kernel, not
counted): how often the mechanism engages.  Nothing where it never ran."""

LAYER = "Reg2d (nn.reg)"
UNIT = "launches"
MOVES = "train_step_ms"


def read(r):
    from mvsbench.trace import UNIT as STEP

    if not r.units:
        return None
    ops = r.trace.launched_in(STEP, lambda name: "conv_wgrad_kernel" in name)
    return len(ops) / r.units if ops else None
