"""The port's benchmark: one run of one cell.

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards.  It loads
the cell's configuration, traffic and driver by name (cells.py), sets up,
warms every shape the traffic uses, measures for `--seconds`, checks what
the window produced against the plain reference (check.py), and prints one
JSON line last on standard output:

  {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
   "checks"}

With --trace 0 the metrics are the cell's end-to-end metrics; with
--trace 1 a profiler traces a steady sub-window and the metrics are the
cell's per-layer metrics (mvsbench/metrics/<name>.py), with `busy_s` and
`window_s` in `device` and the top device operations and idle gaps in
`breakdown`.  The numbers compared are printed last on standard error
and under `checks`, each beside its limit.

It exits non-zero, printing no result, where there is no card or fewer
than the cell asks for, and where the process has loaded JAX, flax or the
JAX package once the window has closed.  The program's kernel builds and
caches stay inside the checkout (build/).  Large host buffers stay in the
heap (common.steady_heap).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from mvsbench.common import process_start

T_START = process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "mvster_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: str):
    """Fixed cache directories inside the checkout, for any builder that
    reads them."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["USE_FLAX"] = "0"


def per_layer(cell, readings) -> dict:
    from mvsbench.cells import load_metric

    out = {}
    for name in cell.per_layer:
        metric = load_metric(name)
        value = metric.read(readings) if readings is not None else None
        if value is not None:
            out[name] = {"value": value, "unit": metric.UNIT}
    return out


UNITS = {"views_per_s": "views/s", "view_p95_ms": "ms", "train_step_ms": "ms",
         "peak_mem_gib": "GiB", "setup_s": "s"}


def measure(cell, seed, seconds, trace, device) -> dict:
    """Set-up, the window and the check of one run of `cell` on `device`:
    the result line (a dict), `checks` last."""
    import torch

    from mvsbench.check import verdict
    from mvsbench.common import say

    driver = importlib.import_module(f"mvsbench.drivers.{cell.driver}")
    res = driver.run(cell, seed, seconds, trace, device, T_START)
    from mvster_tpu_torch.kernels import _build

    say(f"set-up ran nvcc for {_build.build_seconds} s; end to end: {json.dumps(res['e2e'])}")
    correct, checks = verdict(res["values"], cell.limits)
    if trace:
        metrics = per_layer(cell, res["readings"])
    else:
        metrics = {k: {"value": res["e2e"][k], "unit": UNITS[k]} for k in cell.end_to_end}
    cuda = device.type == "cuda"
    line = {"correct": bool(correct), "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else device.type,
                       "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                       "count": cell.chips,
                       "memory_peak_bytes": int(res["memory_peak_bytes"])}}
    if trace:
        tr = res["readings"].trace
        line["device"]["busy_s"] = res.get("busy_s", tr.busy_s)
        line["device"]["window_s"] = res.get("window_s", tr.window_s)
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from mvsbench.cells import ROOT, Cell
    from mvsbench.common import card_line, say, steady_heap

    steady_heap()
    cache_dirs(ROOT)
    cell = Cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA device(s); {have} available")
        return 2
    say(f"card: {card_line()}")
    line = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        say(f"loaded in this process: {', '.join(bad)}")
        return 3
    for name, c in line["checks"].items():
        say(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
