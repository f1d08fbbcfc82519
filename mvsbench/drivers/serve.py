"""Serving: reference views through tools.test.infer_views, a closed loop
of one client.

Set-up builds the model as tools.test.main builds it (the configuration's
flags through the port's test parser, TF32 off, weights loaded strictly,
`.eval()` on the card), makes the traffic's pool of samples on the host,
and runs `warmup` views.  The window hands infer_views the pool's samples
in turn, each as infer_views asks for it, until `seconds` have passed, and
takes each answer as it is yielded, its depth and confidence on the host.
A view's latency runs from its hand-over to its answer; the window from
the first hand-over to the last answer.  Answers are kept for the check by
a reservoir sample of `check_views`, drawn from the seed.

With a trace, the profiler runs from the hand-over of view `trace_after`
of the window through the answer of `trace_count` views later (then
waiting for the forward already launched), with ranges on the model (a
unit), model.feature and each model.reg[s].
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mvsbench import check, traffic, work
from mvsbench.cells import flags
from mvsbench.common import Readings, free_cuda, say
from mvsbench.trace import UNIT, Profiler, Ranges, warm


def port_model(config: dict):
    """The port's model of a configuration's `model`, as tools.test.main
    builds it: the flags through the port's test parser."""
    from mvster_tpu_torch.models.mvs4net import MVS4Net
    from mvster_tpu_torch.tools.cli import build_test_parser, model_config_from_args

    args = build_test_parser().parse_args(
        ["--testpath", ".", "--testlist", "scan1", "--loadckpt", "seeded",
         *flags(config["model"])])
    return MVS4Net(model_config_from_args(args))


def build(cell, seed, device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = cell.weights(seed, device)
    model = port_model(cell.config)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval(), sd


def run(cell, seed, seconds, trace, device, t_start):
    from mvster_tpu_torch.tools.test import infer_views

    t = cell.traffic
    model, sd = build(cell, seed, device)
    say(f"set-up: model at {time.perf_counter() - t_start:.2f} s")
    pool = traffic.pool(t, seed)
    say(f"set-up: pool at {time.perf_counter() - t_start:.2f} s")
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in infer_views(model, (pool[i % len(pool)] for i in range(t["warmup"])), t["batch"]):
        pass
    sync()
    if trace:
        warm(lambda: (list(infer_views(model, pool[:1], t["batch"])), sync()))
    say(f"set-up: warm at {time.perf_counter() - t_start:.2f} s")
    prof = Profiler() if trace else None
    ranges = (Ranges([(UNIT, model), ("model.feature", model.feature)]
                     + [("model.reg", reg) for reg in model.reg]) if trace else None)
    first, count = t["trace_after"], t["trace_count"]
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    handed = []
    rng = np.random.default_rng(seed)
    kept = []

    def feed():
        i = 0
        while True:
            now = time.perf_counter()
            if now >= deadline:
                return
            if prof is not None and i == first:
                prof.start()
            handed.append(now)
            yield i
            i += 1

    deadline = time.perf_counter() + seconds
    t0 = time.perf_counter()
    samples = (pool[i % len(pool)] for i in feed())
    latencies = []
    for n, (sample, answer) in enumerate(infer_views(model, samples, t["batch"])):
        latencies.append(time.perf_counter() - handed[n])
        if n < t["check_views"]:
            kept.append((sample, answer))
        else:
            j = int(rng.integers(0, n + 1))
            if j < t["check_views"]:
                kept[j] = (sample, answer)
        if prof is not None and prof.running and n == first + count - 1:
            sync()
            prof.stop()
    t1 = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    views = len(latencies)
    e2e = {"views_per_s": views / (t1 - t0),
           "view_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
           "peak_mem_gib": window_peak / 2**30,
           "setup_s": t0 - t_start}
    done = np.array(handed[:views]) + np.array(latencies) - t0
    quarters = np.histogram(done, bins=4, range=(0.0, t1 - t0))[0]
    say(f"window: {views} views in {t1 - t0:.3f} s, {len(handed)} handed; by quarter "
        f"{quarters.tolist()}; latency p50 {np.percentile(latencies, 50) * 1e3:.1f} ms")

    readings = None
    if prof is not None:
        ranges.remove()
        if prof.running:
            prof.stop()
        tr = prof.trace()
        flops = work.reference_flops(cell.reference, cell.ref_config, t["height"], t["width"],
                                     t["views"], t["batch"], train=False)
        readings = Readings(cell, tr, flops=flops, host={})
    del model
    free_cuda()
    t2 = time.perf_counter()
    values = check.judge_views(cell.reference, sd, cell.ref_config, kept, device)
    say(f"check: {len(kept)} views in {time.perf_counter() - t2:.2f} s")
    return {"attempted": len(handed), "failed": len(handed) - views, "e2e": e2e,
            "values": values, "memory_peak_bytes": max(setup_peak, window_peak),
            "readings": readings}
