"""What the port's own spans give the per-layer readers.

The port marks its phases with `record_function` ranges while a profiler
records (mvster_tpu_torch/utils/profiling.py): `infer.h2d`,
`infer.forward`, `infer.wait` a served chunk, `train.batch_wait`,
`train.h2d`, `train.step` and inside it `train.forward`, `train.loss`,
`train.backward`, `train.optimizer` a step, and `mvs.fpn`,
`mvs.cost_volume`, `mvs.reg` in the model.  They land in the traced run's
trace beside the kernels and the CUDA runtime calls, on one clock, and
these helpers read them from the public fields of mvsbench.trace.Trace
alone: `ranges`, `host` and `busy_intervals()`.

Each span read here runs once a unit (a served chunk, a train step), so
its time a unit is the mean over the spans of that name in the trace: the
profiler starts inside the first traced step, after that step's batch
wait and input copy, so those two spans number one less than the steps.
A runtime call or an idle stretch belongs to a span by time, whatever
thread made it (the autograd engine launches the backward from its own).
Where the trace holds no span of the name (a program without the spans)
every helper returns None.
"""

from __future__ import annotations

import bisect

SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def spans(trace, name):
    """The spans of that name, (start, end) in us, sorted."""
    return sorted(trace.ranges.get(name, []))


def host_ms(trace, name):
    """Mean host ms of a span of that name."""
    s = spans(trace, name)
    return sum(b - a for a, b in s) / len(s) * 1e-3 if s else None


def _inside(s, t):
    """Whether time t lies inside one of the sorted, disjoint spans s."""
    i = bisect.bisect_right(s, (t, float("inf"))) - 1
    return i >= 0 and s[i][0] <= t <= s[i][1]


def launches(trace):
    """Start times of the kernel-launch runtime and driver calls (named
    *LaunchKernel*; a cudaGraphLaunch counts once), leaving out a driver
    call made inside a runtime call on the same thread: one a launch."""
    calls = sorted((ts, ts + dur, tid) for name, ts, dur, tid in trace.host
                   if "LaunchKernel" in name or name == "cudaGraphLaunch")
    out, open_end = [], {}
    for start, end, tid in calls:
        if start < open_end.get(tid, float("-inf")):
            continue
        open_end[tid] = end
        out.append(start)
    return out


def syncs(trace):
    """Start times of the host-blocking runtime calls."""
    return [ts for name, ts, _, _ in trace.host if name in SYNCS]


def calls_per_span(trace, name, starts):
    """Mean number of the calls (their start times) that start inside a
    span of that name."""
    s = spans(trace, name)
    if not s:
        return None
    return sum(_inside(s, t) for t in starts) / len(s)


def idle_ms(trace, name):
    """Mean ms of a span of that name in which no device operation runs:
    its length less its overlap with the device's busy intervals."""
    s = spans(trace, name)
    if not s:
        return None
    busy = trace.busy_intervals()
    ends = [b for _, b in busy]
    idle = 0.0
    for a, b in s:
        covered = 0.0
        for lo, hi in busy[bisect.bisect_right(ends, a):]:
            if lo >= b:
                break
            covered += min(hi, b) - max(lo, a)
        idle += (b - a) - covered
    return idle / len(s) * 1e-3
