"""What the drivers share: the process clock, the card, freeing the
program, and what the per-layer readers read."""

from __future__ import annotations

import ctypes
import gc
import os
import subprocess
import sys
import time

M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3  # glibc's mallopt parameters


def process_start() -> float:
    """This process's start on the time.perf_counter() clock (from Linux's
    /proc; the clock now where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def steady_heap():
    """Keep large host buffers in glibc's heap: a buffer freed is reused, not
    unmapped.  glibc maps every allocation over its mmap threshold (at most
    32 MiB by default) afresh and returns it on free, so each ~57 MB input
    stack of a served view paid fresh page faults and zeroing, whose cost
    swung with the host's memory state: 12.5-20.8 views/s over runs of one
    seed against 21.3-21.6 with the buffers kept (PERF.md).  No-op where
    the C library is not glibc."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
    libc.mallopt(M_TRIM_THRESHOLD, 1 << 31)


def cpu_seconds() -> float:
    """This process's CPU seconds, all its threads."""
    t = os.times()
    return t.user + t.system


def quartiles(seconds) -> str:
    """'q1/median/q3 max' of a list of seconds, in ms."""
    import statistics

    ms = [x * 1e3 for x in seconds]
    if len(ms) < 2:
        return "n/a"
    q = statistics.quantiles(ms, n=4)
    return f"{q[0]:.1f}/{q[1]:.1f}/{q[2]:.1f} max {max(ms):.1f}"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def free_cuda():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Readings:
    """What a traced run leaves for the per-layer readers.

    trace: mvsbench.trace.Trace of the sub-window (None when untraced);
    units: the forwards or steps in it; flops: the reference's FLOPs a
    unit; host: {span: [seconds, one a traced unit]} of the harness's
    host-clock spans; cell: the cell.
    """

    def __init__(self, cell, trace, flops, host):
        self.cell = cell
        self.trace = trace
        self.units = trace.units if trace is not None else 0
        self.flops = flops
        self.host = host

    def per_unit_s(self, name_filter, range_name=None):
        """Device seconds a unit of the matching kernels launched in the
        units (or in ranges of `range_name`); None where none ran."""
        from mvsbench.trace import UNIT

        if not self.units:
            return None
        ops = self.trace.launched_in(range_name or UNIT, name_filter)
        if not ops:
            return None
        return sum(op[2] for op in ops) * 1e-6 / self.units

    def roofline_pct(self, least_s, name_filter):
        """A kernel's least seconds a unit over the device seconds a unit of
        the matching kernels, in %."""
        t = self.per_unit_s(name_filter)
        if t is None or not least_s:
            return None
        return 100.0 * least_s / t

    def unit_s(self):
        """Seconds a unit in the traced window."""
        return self.trace.window_s / self.units if self.units else None
