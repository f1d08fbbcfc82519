"""Launches a view of K7's kernel (deform_conv_kernel, the DCN heads'
sampling and contraction) inside the port's `infer.forward` spans: how
often the mechanism engages, four a forward with --dcn.  Nothing where it
never ran."""

LAYER = "DCN heads (nn.dcn)"
UNIT = "launches"
MOVES = "views_per_s"


def read(r):
    from mvsbench.spans import spans

    forwards = spans(r.trace, "infer.forward") if r.units else []
    if not forwards:
        return None
    ops = r.trace.launched_in("infer.forward", lambda name: "deform_conv_kernel" in name)
    return len(ops) / len(forwards) / r.cell.traffic["batch"] if ops else None
