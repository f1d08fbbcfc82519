"""Smoke-run the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. device: the card's name and power limit; TF32 off for matmuls and convs
  2. build: compile and load the CUDA kernels from mvster_tpu_torch/csrc
  3. kernel: the fused cost-volume kernel against its plain PyTorch version
     on the card at the four DTU-mid stage shapes, both attention modes,
     at atol/rtol 1e-4
  4. forward: MVS4Net eval at 512x640, 5 views, dtu_default(mono=False),
     seeded random weights, checked for finite depth in the cascade's
     reachable range (stage 1 inside [dmin, dmax]), 4 kernel
     launches, and against the same model run on the CPU (plain path) by
     the stage comparator of tests/_torch_parity.py
  5. serve: tools.test.infer_views answers 3 reference views (eval_batch 1)
  6. times: steady-state forward and per-stage kernel vs plain, CUDA events

The last three lines are the card's name and power limit, a JSON line with
the kernels' launches, errors and times (summed over the four stages), and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from _torch_parity import assert_stage_close, stage_inputs, t, to_numpy_tree  # noqa: E402
from helpers import synthetic_sample  # noqa: E402
from mvster_tpu_torch.kernels import _build, warp_correlate  # noqa: E402
from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig  # noqa: E402
from mvster_tpu_torch.tools.test import infer_views  # noqa: E402
from mvster_tpu_torch.tools.weights import random_state_dict  # noqa: E402

H, W, NVIEWS = 512, 640, 5
# (H, W, C, D, G) of each DTU-mid stage under dtu_default
STAGES = [(64, 80, 64, 8, 8), (128, 160, 32, 8, 8), (256, 320, 16, 4, 4),
          (512, 640, 8, 4, 4)]
KERNEL_TOL = 1e-4  # atol = rtol; kernel and plain sample at identical coordinates
KERNEL = dict(name="warp_correlate", route="cuda",
              source="mvster_tpu_torch/csrc/warp_correlate.cu",
              replaces="mvster_tpu/kernels/pallas_warp.py:250")


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    """Mean device milliseconds per call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def model_inputs(sample, device):
    return (t(sample["imgs"], device),
            {k: t(v, device) for k, v in sample["proj_matrices"].items()},
            t(sample["depth_values"], device))


def build_model(seed):
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False))
    sd = random_state_dict(model, seed)
    # BatchNorm running statistics perturbed from a numpy seed
    rng = np.random.default_rng(seed)
    for key in sd:
        if key.endswith("running_mean"):
            sd[key] = t(rng.normal(0.0, 0.2, sd[key].shape))
        elif key.endswith("running_var"):
            sd[key] = t(rng.uniform(0.5, 2.0, sd[key].shape))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1 device] {kind} | {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | TF32 off for matmul and cuDNN")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"[2 build] {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s)")

    # 3. kernel against plain at the DTU-mid stage shapes
    stage_args, errs = [], []
    for si, (h, w, c, d, g) in enumerate(STAGES):
        inp = stage_inputs(100 + si, h, w, c, d, nsrc=NVIEWS - 1)
        args = [t(inp[k], dev) for k in ("ref", "src", "ref_proj", "src_projs", "hypo")]
        stage_args.append((args, g))
        stage_err = 0.0
        for fuse in (True, False):
            got = warp_correlate.fused_cost_volume(*args, g, 2.0, fuse)
            want = warp_correlate.fused_cost_volume_plain(*args, g, 2.0, fuse)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"stage{si + 1}: non-finite kernel output")
            torch.testing.assert_close(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
            stage_err = max(stage_err, (got - want).abs().max().item())
        errs.append(stage_err)
    log("[3 kernel] vs plain, atol=rtol=1e-4, max|d| per stage: "
        + ", ".join(f"s{i + 1} {e:.3e}" for i, e in enumerate(errs)))

    # 4. the full forward on the card, against the CPU plain path
    sample = synthetic_sample(0, nviews=NVIEWS, h=H, w=W)
    model_cpu = build_model(seed=0)
    model = copy.deepcopy(model_cpu).to(dev)
    with torch.inference_mode():
        warp_correlate.fused_cost_volume.launches = 0
        out = model(*model_inputs(sample, dev))
        torch.cuda.synchronize()
        launches = warp_correlate.fused_cost_volume.launches
        ref = model_cpu(*model_inputs(sample, "cpu"))
    out, ref = to_numpy_tree(out), to_numpy_tree(ref)
    depth, conf = out["depth"], out["photometric_confidence"]
    dmin, dmax = sample["depth_values"][0, 0], sample["depth_values"][0, -1]
    # stage 1 spans [dmin, dmax]; each later stage centres its window on the
    # previous depth in inverse depth, so the final depth may pass the range
    # by under one stage-1 inverse-depth bin (half a bin, then 1/7 of that, ...)
    bin1 = (1 / dmin - 1 / dmax) / (STAGES[0][3] - 1)
    lo, hi = 1 / (1 / dmin + bin1), 1 / (1 / dmax - bin1)
    d1 = out["stage1"]["depth"]
    if d1.min() < dmin * (1 - 1e-6) or d1.max() > dmax * (1 + 1e-6):
        raise AssertionError(f"stage-1 depth [{d1.min()}, {d1.max()}] outside [{dmin}, {dmax}]")
    if launches != 4:
        raise AssertionError(f"expected 4 kernel launches per forward, got {launches}")
    if depth.shape != (1, H, W) or conf.shape != (1, H, W):
        raise AssertionError(f"shapes {depth.shape}, {conf.shape}")
    if not (np.isfinite(depth).all() and np.isfinite(conf).all()):
        raise AssertionError("non-finite depth or confidence")
    if depth.min() < lo or depth.max() > hi:
        raise AssertionError(f"depth [{depth.min()}, {depth.max()}] outside [{lo}, {hi}]")
    assert_stage_close(ref, out)
    log(f"[4 forward] {H}x{W}, {NVIEWS} views: depth [{depth.min():.2f}, {depth.max():.2f}] "
        f"in [{lo:.2f}, {hi:.2f}] (stage 1 in [{dmin}, {dmax}]), conf [{conf.min():.3f}, {conf.max():.3f}], "
        f"{launches} kernel launches, matches the CPU plain path by the stage comparator")

    # 5. serve a few requests through the inference tool's loop (the main path)
    requests = []
    for seed in (1, 2, 3):
        s = synthetic_sample(seed, nviews=NVIEWS, h=H, w=W)
        requests.append({"imgs": s["imgs"][0],
                         "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()},
                         "depth_values": s["depth_values"][0]})
    warp_correlate.fused_cost_volume.launches = 0
    served = list(infer_views(model, requests, eval_batch=1))
    main_path_launches = warp_correlate.fused_cost_volume.launches
    if len(served) != 3 or main_path_launches != 4 * len(served):
        raise AssertionError(f"{len(served)} requests, {main_path_launches} launches")
    for _, res in served:
        if not np.isfinite(res["depth"]).all() or res["depth"].shape != (1, H, W):
            raise AssertionError("bad served depth")
    log("[5 serve] infer_views, 3 requests, latency ms: "
        + ", ".join(f"{1e3 * r['seconds']:.2f}" for _, r in served)
        + f" | {main_path_launches} kernel launches | {card}")

    # 6. times
    inputs = model_inputs(sample, dev)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(*inputs), iters=20)
    log(f"[6 times] forward {fwd_ms:.3f} ms = {fwd_ms / 1e3:.5f} s/view "
        f"(512x640, 5 views, batch 1, f32) | {card}")
    k_total = w_total = p_total = 0.0
    for si, (args, g) in enumerate(stage_args):
        ref_feat, src_feats, ref_proj, src_projs, hypo = args
        rot, trans = warp_correlate.plane_sweep_rts(ref_proj, src_projs)

        def kern():  # the kernel alone, on precomputed rot/trans
            warp_correlate.launch(ref_feat, src_feats, hypo, rot, trans, g, 2.0, True)

        def wrapped():  # what the main path calls: rot/trans, then the kernel
            warp_correlate.fused_cost_volume(*args, g, 2.0, True)

        def plain():
            warp_correlate.fused_cost_volume_plain(*args, g, 2.0, True)

        # in turns, plain-kernel-kernel-plain, inside one call on one card
        p1, k1, w1, w2, k2, p2 = (cuda_ms(f, iters=20)
                                  for f in (plain, kern, wrapped, wrapped, kern, plain))
        k_ms, w_ms, p_ms = (k1 + k2) / 2, (w1 + w2) / 2, (p1 + p2) / 2
        k_total += k_ms
        w_total += w_ms
        p_total += p_ms
        log(f"[6 times] stage{si + 1} {STAGES[si][:2]} C={STAGES[si][2]} D={STAGES[si][3]} "
            f"G={g}: kernel {k_ms:.4f} ms, with rot/trans {w_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms | {card}")

    print(card)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=main_path_launches, max_abs_err=max(errs),
        ms=k_total, plain_ms=p_total, wrapper_ms=w_total,
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
