"""A torch.profiler trace of a steady sub-window, reduced to what the
per-layer metrics read.

The profiler (CPU and CUDA activities) is started and stopped by the
driver at unit boundaries (an eval forward, a train step).  The harness
marks each unit with a `record_function` range (`bench.unit`), and module
hooks mark `model.feature` and `model.reg`.  Its Chrome trace is exported
to a temporary file, read and deleted.  Kernels are joined to the host
call that launched them through the trace's correlation ids, so a range's
device time is the summed duration of the kernels launched inside it, on
any thread (the autograd engine launches the backward from its own).

The window runs from the start of the first unit to the end of the last
device operation launched in a unit.  Busy time is the union of device
operation intervals (kernels, copies, sets) inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

UNIT = "bench.unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Profiler:
    """torch.profiler started and stopped by hand; `trace()` after stop."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.running = False

    def start(self):
        self._prof.start()
        self.running = True

    def stop(self):
        self._prof.stop()
        self.running = False

    def trace(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return Trace(events)


def warm(fn):
    """Run fn() under a profiler that is thrown away: the first profiler
    start of a process pays CUPTI's set-up, which belongs to set-up."""
    prof = Profiler()
    prof.start()
    try:
        fn()
    finally:
        prof.stop()


class Ranges:
    """record_function ranges opened by a forward pre-hook and closed by a
    forward hook on each module of [(name, module)]."""

    def __init__(self, modules):
        import torch

        self._open = {}
        self._handles = []
        for name, module in modules:
            def pre(_m, _a, name=name):
                rf = torch.autograd.profiler.record_function(name)
                rf.__enter__()
                self._open[name] = rf

            def post(_m, _a, _o, name=name):
                self._open.pop(name).__exit__(None, None, None)

            self._handles += [module.register_forward_pre_hook(pre),
                              module.register_forward_hook(post)]

    def remove(self):
        for h in self._handles:
            h.remove()


def unit_range():
    """The range that marks one unit of work (a forward, a step)."""
    import torch

    return torch.autograd.profiler.record_function(UNIT)


class Trace:
    def __init__(self, events):
        ops = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [(e["name"], float(e["ts"]), float(e["dur"]),
                        e.get("args", {}).get("correlation"))
                       for e in ops if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e["dur"]), e.get("tid"))
                     for e in ops if e.get("cat") in HOST_CATS]
        launch = {}
        for e in ops:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = float(e["ts"])
        self.launch = launch
        self.ranges = defaultdict(list)
        for e in ops:
            if e.get("cat") == "user_annotation":
                self.ranges[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        units = sorted(self.ranges.get(UNIT, []))
        self.units = len(units)
        if not units:
            self.t0 = self.t1 = 0.0
            return
        in_units = self.launched_in(UNIT)
        self.t0 = units[0][0]
        self.t1 = max([units[-1][1]] + [ts + dur for _, ts, dur, _ in in_units])

    def launched_in(self, range_name, name_filter=None):
        """Device operations whose launch lies inside a range of that name."""
        spans = sorted(self.ranges.get(range_name, []))
        if not spans:
            return []
        starts = [s for s, _ in spans]
        out = []
        for op in self.device:
            name, _, _, corr = op
            if name_filter is not None and not name_filter(name):
                continue
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(op)
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        """The union of device-operation intervals inside the window (us)."""
        ivs = sorted((max(ts, self.t0), min(ts + dur, self.t1))
                     for _, ts, dur, _ in self.device if ts + dur > self.t0 and ts < self.t1)
        merged = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, name_filter, range_name=UNIT) -> float:
        """Summed seconds of the matching operations launched in the units."""
        return sum(dur for _, _, dur, _ in self.launched_in(range_name, name_filter)) * 1e-6

    def top_device_ops(self, n=10):
        total = defaultdict(float)
        for name, ts, dur, _ in self.device:
            if ts >= self.t0 and ts < self.t1:
                total[name[:160]] += dur * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10, short_us=20.0, lookback=4000):
        """The device's idle time inside the window, summed by what the host
        was doing at each gap's middle: its innermost traced operation among
        the `lookback` that started last before it; gaps under short_us
        together as one entry."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        total = defaultdict(float)
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            if b - a < short_us:
                total[f"gaps under {short_us:g} us"] += (b - a) * 1e-6
                continue
            mid = (a + b) / 2
            j = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, j - lookback):j] if h[1] + h[2] >= mid]
            name = min(inner, key=lambda h: h[2])[0] if inner else "host: untraced"
            total[name[:160]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]
