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
  7. kernels K2/K3: the warp gather and its scatter-add backward against
     their plain versions at the four DTU-mid stage shapes (four source
     views) and the four 576x768 fine-tune stage shapes (two), batch 2 (K2
     atol 1e-6, K3 rtol 1e-4 / atol 1e-5), and the autograd Function's
     source gradient against autograd through the plain gather
  8. train: tools.train.main, one epoch of dtu_default() at 512x640, 5
     views, batch 2 (17 steps) and a val pass, on a synthetic DTU tree
     written at full size; finite losses, parameters moved, 16 K2 and 16 K3
     launches per step, and the checkpoint serves one request through K1
  9. card vs CPU: one train step at 128x192, 3 views, batch 1, on the card
     and on the CPU plain path: loss rtol 1e-4, stage outputs by the
     comparator, gradients by relative L2 within the float32 noise that the
     CPU's float64 step measures
 10. learns: tests/test_training_learns.py's setup on the card; the
     final-stage abs depth error drops at least 5x
 11. times: the DTU-mid train step (batch 2) by CUDA events, its peak memory
     and a torch.profiler breakdown; per stage K2, K3, F.grid_sample forward
     and backward, and the plain versions, in turns, each timed back to
     back and (kernels and F.grid_sample) queued behind a spin of the card,
     which times the device and not the host's dispatch; each kernel's
     achieved bytes/s against 3.35 TB/s, and K3's global REDs (float4, and
     the scalar ones of one RED a channel)
 12. kernels K4/K5: the fused Sinkhorn loss's forward and backward against
     their plain versions at the four DTU-mid stage shapes, batch 2, 10
     iterations (K4 rtol 1e-5 / atol 1e-6 per pixel; K5 rtol 1e-4 with an
     absolute floor of 1e-4 of the largest |dL/dpred|), and the autograd
     Function's gradient against autograd through the plain forward (the
     K5 tolerance)
 13. fine-tune: tools.train.main --dataset blendedmvs --ot_backend pallas,
     one epoch at 576x768, 7 views, batch 2 (3 steps) and a val pass, on a
     synthetic BlendedMVS tree written at full size, from phase 8's
     checkpoint (--loadckpt); finite loss, EPE, err1 and err3, parameters
     moved, per step 4 K4, 4 K5, 24 K2 and 24 K3 launches, per val batch 4
     K1 and 4 K4
 14. backends: one DTU-mid batch-2 train step with ot_backend pallas and
     xla from the same weights and batch: per-stage OT losses at rtol
     1e-5, gradients within the float32 noise that a float64 step on the
     card (plain warp) measures, as tests/_torch_parity.check_grads holds
     them
 15. times: per stage K4, K5, their plain versions and both backends' loss
     forward+backward; the DTU-mid train step with pallas and with xla; the
     BlendedMVS step and its peak memory; CUDA events, in turns

The last three lines are the card's name and power limit, a JSON line with
the kernels' launches, errors and times (summed over the four stages; K2
and K3 for one source view per stage, as one launch covers, and timed
queued, as F.grid_sample beside them), and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from _torch_parity import (  # noqa: E402
    GRAD_NOISE,
    assert_stage_close,
    plane_batch,
    relative_l2,
    stage_inputs,
    t,
    to_numpy_tree,
    torch_batch,
    write_blendedmvs_tree,
    write_dtu_tree,
)
from helpers import synthetic_sample  # noqa: E402
from mvster_tpu_torch.core.geometry import plane_sweep_coords  # noqa: E402
from mvster_tpu_torch.core.sampling import bilinear_taps  # noqa: E402
from mvster_tpu_torch.dist.train_step import make_train_step  # noqa: E402
from mvster_tpu_torch.kernels import _build, sinkhorn_ot, warp_correlate, warp_vjp  # noqa: E402
from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig  # noqa: E402
from mvster_tpu_torch.tools.test import infer_views  # noqa: E402
from mvster_tpu_torch.tools.weights import (  # noqa: E402
    init_state_dict,
    load_reference_ckpt,
    random_state_dict,
)

H, W, NVIEWS = 512, 640, 5
# (H, W, C, D, G) of each DTU-mid stage under dtu_default
STAGES = [(64, 80, 64, 8, 8), (128, 160, 32, 8, 8), (256, 320, 16, 4, 4),
          (512, 640, 8, 4, 4)]
# ... and of the BlendedMVS fine-tune's 576x768 stages
BLEND_STAGES = [(72, 96, 64, 8, 8), (144, 192, 32, 8, 8), (288, 384, 16, 4, 4),
                (576, 768, 8, 4, 4)]
KERNEL_TOL = 1e-4  # atol = rtol; kernel and plain sample at identical coordinates
KERNEL = dict(name="warp_correlate", route="cuda",
              source="mvster_tpu_torch/csrc/warp_correlate.cu",
              replaces="mvster_tpu/kernels/pallas_warp.py:250")
K2 = dict(name="warp_gather", route="cuda", source="mvster_tpu_torch/csrc/warp_scatter.cu",
          replaces="mvster_tpu/kernels/pallas_warp.py:568")
K3 = dict(name="warp_scatter", route="cuda", source="mvster_tpu_torch/csrc/warp_scatter.cu",
          replaces="mvster_tpu/kernels/pallas_scatter.py:89")
K4 = dict(name="sinkhorn_fwd", route="cuda", source="mvster_tpu_torch/csrc/sinkhorn_ot.cu",
          replaces="mvster_tpu/kernels/pallas_sinkhorn.py:71")
K5 = dict(name="sinkhorn_bwd", route="cuda", source="mvster_tpu_torch/csrc/sinkhorn_ot.cu",
          replaces="mvster_tpu/kernels/pallas_sinkhorn.py:82")
BATCH = 2  # the training cell's batch
K2_ATOL = 1e-6  # K2 repeats the plain version's rounded operations
K3_RTOL, K3_ATOL = 1e-4, 1e-5  # K3's atomics sum in no fixed order
# the published DTU training flags (scripts/train_dtu.sh) at DTU-mid, batch 2
TRAIN_FLAGS = ["--batch_size", str(BATCH), "--nviews", str(NVIEWS), "--epochs", "1",
               "--group_cor", "--inverse_depth", "--mono", "--attn_temp", "2",
               "--summary_freq", "1"]
LOSS_KW = dict(inverse_depth=True, ot_iter=10, mono=True)  # l1ot_lw (0, 1)
OT_ITERS = 10
K4_RTOL, K4_ATOL = 1e-5, 1e-6  # per-pixel loss: the plain version's steps, own exp/log
# K5: rtol, and an absolute floor as a fraction of the largest |dL/dpred|
# (where pred underflows to 0, dL/dpred = dlog_nu / 1e-12 magnifies rounding)
K5_RTOL, K5_FLOOR = 1e-4, 1e-4
# the BlendedMVS fine-tune (SURVEY.md: 768x576, 7 views), batch 2
BLEND_H, BLEND_W, BLEND_VIEWS = 576, 768, 7
BLEND_FLAGS = ["--dataset", "blendedmvs", "--ot_backend", "pallas", "--nviews",
               str(BLEND_VIEWS), "--batch_size", str(BATCH), "--epochs", "1",
               "--group_cor", "--inverse_depth", "--mono", "--attn_temp", "2",
               "--summary_freq", "1"]
# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores; per clock and SM, its float32
# pipe starts 128 FFMA, FADD or FMUL and its special-function units (MUFU:
# ex2, rcp) 16
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FMA_PER_CLOCK_PER_SM = 128
MUFU_PER_CLOCK_PER_SM = 16
QUEUE_SPIN_CYCLES = int(50e-3 * 1.98e9)  # queued_ms: ~50 ms at 1980 MHz
# one accurate expf, logf and float32 division each, compiled as the port's
# kernels are (math_costs counts their SASS)
MATH_PROBE = r"""
#define PROBE(name, expr) extern "C" __global__ void name(const float* x, float* y) \
  { const int i = threadIdx.x; y[i] = expr; }
PROBE(probe_none, x[i])
PROBE(probe_exp, expf(x[i]))
PROBE(probe_log, logf(x[i]))
PROBE(probe_div, x[i] / x[i + 32])
"""


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


def queued_ms(fn, iters, warmup=3):
    """Mean device milliseconds per call of fn, by CUDA events, with the
    calls queued behind a 50 ms spin of the card: the host enqueues them
    while the card waits, so a call shorter than its own Python and
    dispatch time is timed by its kernels, not by the host."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    if host_s > 0.04:  # the card finished its spin before the host queued the calls
        raise AssertionError(f"queueing {iters} calls took {host_s * 1e3:.1f} ms of host time")
    return start.elapsed_time(end) / iters


def gbs(nbytes, ms):
    return f"{nbytes / ms / 1e6:.1f}"


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


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time for nbytes of device
    memory traffic and flops float32 operations at the card's peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k1_work(h, w, c, d, g, b=1, v=NVIEWS - 1):
    """K1's unique bytes (ref, source maps, hypotheses, rot/trans, output
    read or written once) and operations (per pixel, view and hypothesis:
    ~30 for the coordinates and weights, 9 per channel for the four taps
    and the correlation)."""
    nbytes = 4 * (b * h * w * c + v * b * h * w * c + b * d * h * w + v * b * 12
                  + b * d * h * w * g)
    return nbytes, b * h * w * v * d * (9 * c + 30)


def k2_work(h, w, c, d, b=BATCH):
    """K2 for one source view: reads src and x, y, writes (B, D, H, W, C);
    7 operations per output value (4 products, 3 sums) and ~20 per
    coordinate.  K3 moves the same bytes the other way (cotangent, x, y
    in; dsrc out) with 8 per cotangent value (4 products, 4 atomic sums)."""
    n = b * d * h * w
    nbytes = 4 * (b * h * w * c + 2 * n + n * c)
    return nbytes, n * (7 * c + 20), n * (8 * c + 20)


def phase7_kernels(dev):
    """K2 and K3 against their plain versions at the DTU-mid stage shapes
    (every source view) and the 576x768 ones (two), batch 2; returns the
    max errors and one DTU-mid view's (src, x, y, cot) per stage for phase
    11."""
    err2 = err3 = errf = 0.0
    per_stage = []
    shapes = [(s, NVIEWS - 1) for s in STAGES] + [(s, 2) for s in BLEND_STAGES]
    for si, ((h, w, c, d, _), views) in enumerate(shapes):
        inp = stage_inputs(200 + si, h, w, c, d, nsrc=views, batch=BATCH)
        ref_proj, hypo = t(inp["ref_proj"], dev), t(inp["hypo"], dev)
        rng = np.random.default_rng(300 + si)
        for v in range(views):
            x, y = plane_sweep_coords(t(inp["src_projs"][v], dev), ref_proj, hypo)
            src = t(inp["src"][v], dev)
            cot = t(rng.normal(size=(BATCH, d, h, w, c)), dev)
            got = warp_vjp.warp_gather(src, x, y)
            want = warp_vjp.warp_plain(src, x, y)
            dsrc = warp_vjp.scatter_grad(cot, x, y, src.shape)
            dwant = warp_vjp.scatter_grad_plain(cot, x, y, src.shape)
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.isfinite(dsrc).all()):
                raise AssertionError(f"stage{si + 1} view {v}: non-finite K2/K3 output")
            torch.testing.assert_close(got, want, rtol=0, atol=K2_ATOL)
            torch.testing.assert_close(dsrc, dwant, rtol=K3_RTOL, atol=K3_ATOL)
            err2 = max(err2, (got - want).abs().max().item())
            err3 = max(err3, (dsrc - dwant).abs().max().item())
            a, b = src.clone().requires_grad_(), src.clone().requires_grad_()
            (warp_vjp.grid_sample_zeros_vjp(a, x, y) * cot).sum().backward()
            (warp_vjp.warp_plain(b, x, y) * cot).sum().backward()
            torch.testing.assert_close(a.grad, b.grad, rtol=K3_RTOL, atol=K3_ATOL)
            errf = max(errf, (a.grad - b.grad).abs().max().item())
            if v == 0 and si < len(STAGES):
                per_stage.append((src, x, y, cot))
    log(f"[7 kernels K2/K3] {len(STAGES)} DTU-mid stages x {NVIEWS - 1} views and "
        f"{len(BLEND_STAGES)} {BLEND_H}x{BLEND_W} stages x 2 views, batch {BATCH}: "
        f"K2 vs plain max|d| {err2:.3e} (atol {K2_ATOL}), K3 vs plain max|d| {err3:.3e} "
        f"(rtol {K3_RTOL}, atol {K3_ATOL}), Function src.grad vs plain autograd "
        f"max|d| {errf:.3e}")
    return err2, err3, per_stage


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase8_train(dev, tmp, card):
    """The training entry point, one epoch at DTU-mid, batch 2; its
    checkpoint then serves one request through K1."""
    from mvster_tpu_torch.tools import train

    root = os.path.join(tmp, "dtu")
    t0 = time.perf_counter()
    write_dtu_tree(root, n_views=NVIEWS, h=H, w=W)
    tree_s = time.perf_counter() - t0
    logdir = os.path.join(tmp, "log")
    argv = ["--trainpath", root, "--trainlist", f"{root}/train.txt",
            "--testlist", f"{root}/train.txt", "--logdir", logdir, *TRAIN_FLAGS]
    warp_vjp.warp_gather.launches = warp_vjp.scatter_grad.launches = 0
    t0 = time.perf_counter()
    result = train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k2, k3 = warp_vjp.warp_gather.launches, warp_vjp.scatter_grad.launches
    steps = result["steps"]
    if steps != NVIEWS * 7 // BATCH:
        raise AssertionError(f"{steps} train steps, expected {NVIEWS * 7 // BATCH}")
    per_step = 4 * (NVIEWS - 1)
    if k2 != per_step * steps or k3 != per_step * steps:
        raise AssertionError(f"K2 {k2} / K3 {k3} launches for {steps} steps, "
                             f"expected {per_step} each per step")
    records = _jsonl(os.path.join(logdir, "metrics.jsonl"))
    losses = [r["loss"] for r in records if r["mode"] == "train"]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"train losses {losses}")
    val = [r for r in records if r["mode"] == "fulltest"]
    if len(val) != 1 or not np.isfinite(val[0]["loss"]):
        raise AssertionError(f"val records {val}")

    config = MVS4NetConfig.dtu_default()
    trained = load_reference_ckpt(result["checkpoint"], config)
    init = init_state_dict(MVS4Net(config), seed=1)  # tools.train's --seed default
    params = {name for name, _ in MVS4Net(config).named_parameters()}
    moved = {k for k in params if not torch.equal(trained[k], init[k])}
    # l1ot_lw (0, 1): the mono decoder's loss weight is 0, so Adam leaves it
    expect = {k for k in params if not k.startswith("mono_depth_decoder.")}
    if moved != expect:
        raise AssertionError(f"moved parameters differ: {sorted(moved ^ expect)[:8]}")

    model = MVS4Net(config)
    model.load_state_dict(trained, strict=True)
    model.to(dev).eval()
    s = synthetic_sample(7, nviews=NVIEWS, h=H, w=W)
    request = {"imgs": s["imgs"][0], "depth_values": s["depth_values"][0],
               "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()}}
    warp_correlate.fused_cost_volume.launches = 0
    served = list(infer_views(model, [request]))
    k1 = warp_correlate.fused_cost_volume.launches
    if k1 != 4 or not np.isfinite(served[0][1]["depth"]).all():
        raise AssertionError(f"checkpoint serving: {k1} K1 launches")
    log(f"[8 train] tools.train.main: {steps} steps of batch {BATCH} at {H}x{W}, "
        f"{NVIEWS} views + a val pass in {train_s:.1f} s (tree written in {tree_s:.1f} s); "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, val loss {val[0]['loss']:.3f}; "
        f"K2 {k2} and K3 {k3} launches ({per_step} per step); {len(moved)} of "
        f"{len(params)} parameter tensors moved (the mono decoder's, weighted 0, did "
        f"not); the checkpoint loaded strictly and served a request through "
        f"{k1} K1 launches in {1e3 * served[0][1]['seconds']:.2f} ms | {card}")
    return k2, k3, root, result["checkpoint"]


def phase9_card_vs_cpu(dev):
    """One train step on the card and on the CPU's plain path, same weights
    and batch; the CPU step in float64 is the exact reference for the
    gradients (the backward through the last stage's Reg2d amplifies
    float32 rounding, in any float32 implementation)."""
    h, w = 128, 192
    config = MVS4NetConfig.dtu_default()
    sd = random_state_dict(MVS4Net(config), seed=9)
    batch_np = plane_batch(1, h=h, w=w)
    runs = {}
    for name, device, dtype in (("card", dev, torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
        model = MVS4Net(config)
        model.load_state_dict(sd, strict=True)
        model.to(device=device, dtype=dtype)
        captured = {}
        model.register_forward_hook(lambda m, i, o: captured.update(out=o))
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                               loss_kwargs=LOSS_KW)
        batch = torch_batch(batch_np, device)
        if dtype == torch.float64:
            batch = {k: ({s: x.double() for s, x in v.items()} if isinstance(v, dict)
                         else v.double()) for k, v in batch.items()}
        scalars, _ = step(batch)
        runs[name] = dict(loss=float(scalars["loss"]), out=to_numpy_tree(captured["out"]),
                          grads={k: p.grad.double().cpu().numpy()
                                 for k, p in model.named_parameters()})
    card, cpu, exact = runs["card"], runs["cpu"], runs["cpu64"]
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-4)
    assert_stage_close(cpu["out"], card["out"])
    worst, worst_key, checked, worst_cpu, worst_card = 0.0, "", 0, 0.0, 0.0
    for key, g_cpu in cpu["grads"].items():
        g_card, g_exact = card["grads"][key], exact["grads"][key]
        if np.linalg.norm(g_exact) < 1e-6:  # zero in exact arithmetic
            np.testing.assert_allclose(g_card, g_cpu, atol=1e-6, err_msg=key)
            continue
        # each float32 gradient's distance from the float64 one: the card
        # must compute the CPU's function (e_card within 30x the CPU's
        # float32 noise, or 1e-3) and agree with the CPU as far as their
        # float32 noise allows
        e_cpu, e_card = relative_l2(g_cpu, g_exact), relative_l2(g_card, g_exact)
        rel = relative_l2(g_card, g_cpu)
        if e_card > max(1e-3, 30 * e_cpu) or rel > max(1e-3, 1.5 * (e_card + e_cpu)):
            raise AssertionError(f"{key}: card vs CPU gradient relative L2 {rel:.2e}; "
                                 f"card vs float64 {e_card:.2e}, CPU vs float64 {e_cpu:.2e}")
        checked += 1
        worst_cpu, worst_card = max(worst_cpu, e_cpu), max(worst_card, e_card)
        if rel > worst:
            worst, worst_key = rel, key
    log(f"[9 card vs CPU] train step at {h}x{w}, 3 views, batch 1: loss "
        f"{card['loss']:.6f} vs {cpu['loss']:.6f} (rtol 1e-4); stage outputs match by "
        f"the comparator; {checked} gradient tensors agree within their float32 "
        f"noise: worst card vs CPU relative L2 {worst:.2e} ({worst_key}); against the "
        f"CPU's float64 step the card's float32 gradients lie up to {worst_card:.2e} "
        f"and the CPU's up to {worst_cpu:.2e}")


def phase10_learns(dev):
    """tests/test_training_learns.py's single-device setup on the card."""
    config = MVS4NetConfig(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
                           fpn_base_channel=4, reg_channel=4, attn_temp=2.0, mono=True)
    model = MVS4Net(config)
    model.load_state_dict(init_state_dict(model, seed=0), strict=True)
    model.to(dev)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                           loss_kwargs=LOSS_KW)
    batch = torch_batch(plane_batch(2), dev)
    warp_vjp.warp_gather.launches = warp_vjp.scatter_grad.launches = 0
    errs, losses = [], []
    for _ in range(60):
        scalars, _ = step(batch)
        errs.append(float(scalars["abs_depth_error"]))
        losses.append(float(scalars["loss"]))
    errs, losses = np.array(errs), np.array(losses)
    launches = (warp_vjp.warp_gather.launches, warp_vjp.scatter_grad.launches)
    start, end = errs[:3].mean(), errs[-3:].mean()
    if not np.isfinite(losses).all() or not end < start / 5:
        raise AssertionError(f"abs depth error {start:.2f} -> {end:.2f}, losses {losses}")
    if not losses[-3:].mean() < 0.7 * losses[:3].mean() or launches != (480, 480):
        raise AssertionError(f"loss {losses[:3]} -> {losses[-3:]}, launches {launches}")
    log(f"[10 learns] 60 steps on two planes at 64x64: abs depth error {start:.2f} -> "
        f"{end:.2f} mm ({start / end:.1f}x), loss {losses[:3].mean():.3f} -> "
        f"{losses[-3:].mean():.3f}; K2/K3 launches {launches}")


def phase11_times(dev, root, per_stage, card):
    """The train step's time, peak memory and profile; K2/K3 per stage."""
    from mvster_tpu_torch.models.losses import mvs4net_loss

    step = train_step_fn(dev, mvs4net_loss, "xla", dtu_batch(root, dev))
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(step, iters=5, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    log(f"[11 times] train step {step_ms:.2f} ms (DTU-mid {H}x{W}, {NVIEWS} views, "
        f"batch {BATCH}, f32, mean of 5 after 2 warm-up, CUDA events); peak memory "
        f"{peak / 2**30:.3f} GiB | {card}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    # the kernels' own events (device type CUDA), summed by name
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    busy = sum(dev_us.values()) / 3 / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    log(f"[11 times] profile of 3 steps: device busy {busy:.2f} ms per step, "
        f"{sum(e.count for e in kernels) // 3} kernel launches per step; top kernels by "
        "device time per step: "
        + "; ".join(f"{k[:70]} {v / 3 / 1e3:.3f} ms" for k, v in top) + f" | {card}")

    sums = dict(k2=0.0, k3=0.0, gs_f=0.0, gs_b=0.0, p2=0.0, p3=0.0, b2=0.0, b3=0.0,
                bytes=0.0, qk2=0.0, qk3=0.0, qgs_f=0.0, qgs_b=0.0)
    by2 = by3 = "bytes"
    for si, (src, x, y, cot) in enumerate(per_stage):
        h, w, c, d, _ = STAGES[si]
        src_nchw = src.permute(0, 3, 1, 2).contiguous().requires_grad_()
        grid = torch.stack([x * (2.0 / (w - 1)) - 1.0, y * (2.0 / (h - 1)) - 1.0],
                           dim=-1).reshape(BATCH, d * h, w, 2)
        cot_nchw = cot.permute(0, 4, 1, 2, 3).reshape(BATCH, c, d * h, w).contiguous()

        def gs_fwd():
            return torch.nn.functional.grid_sample(
                src_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

        gs_out = gs_fwd()

        def gs_bwd():
            torch.autograd.grad(gs_out, src_nchw, cot_nchw, retain_graph=True)

        fns = dict(
            k2=lambda: warp_vjp.warp_gather(src, x, y),
            k3=lambda: warp_vjp.scatter_grad(cot, x, y, src.shape),
            p2=lambda: warp_vjp.warp_plain(src, x, y),
            p3=lambda: warp_vjp.scatter_grad_plain(cot, x, y, src.shape),
            gs_f=gs_fwd, gs_b=gs_bwd,
        )
        order = ["p2", "k2", "gs_f", "p3", "k3", "gs_b"]
        times = {k: [] for k in fns}
        queued = {k: [] for k in ("k2", "gs_f", "k3", "gs_b")}
        for name in order + order[::-1]:  # in turns: forward, then back again
            times[name].append(cuda_ms(fns[name], iters=10))
            if name in queued:
                queued[name].append(queued_ms(fns[name], iters=10))
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        ms.update({"q" + k: sum(v) / len(v) for k, v in queued.items()})
        nbytes, ops2, ops3 = k2_work(h, w, c, d)
        b2, by2 = bound(nbytes, ops2)
        b3, by3 = bound(nbytes, ops3)
        for k in ms:
            sums[k] += ms[k]
        sums["b2"] += b2
        sums["b3"] += b3
        sums["bytes"] += nbytes
        # K3's global REDs: one a (sample, tap of nonzero weight, float4)
        taps = sum(int((wt != 0).sum()) for _, wt in bilinear_taps(x, y, h, w))
        log(f"[11 times] stage{si + 1} {(h, w)} C={c} D={d} B={BATCH}, one view, back to back "
            f"(queued): K2 {ms['k2']:.4f} ({ms['qk2']:.4f}) ms, {gbs(nbytes, ms['qk2'])} GB/s "
            f"queued; F.grid_sample {ms['gs_f']:.4f} ({ms['qgs_f']:.4f}); plain {ms['p2']:.4f}; "
            f"bound {b2:.4f}.  K3 {ms['k3']:.4f} ({ms['qk3']:.4f}) ms, "
            f"{gbs(nbytes, ms['qk3'])} GB/s queued; grid_sample backward {ms['gs_b']:.4f} "
            f"({ms['qgs_b']:.4f}); plain {ms['p3']:.4f}; bound {b3:.4f}; {nbytes / 1e6:.1f} MB; "
            f"K3 issued {taps * c // 4:.4e} float4 REDs ({taps * c // 4 / ms['qk3'] * 1e3:.4e}/s "
            f"queued) where one scalar RED a channel would take {taps * c:.4e} | {card}")
    log(f"[11 times] over the four stages, back to back (queued): K2 {sums['k2']:.4f} "
        f"({sums['qk2']:.4f}) ms vs F.grid_sample {sums['gs_f']:.4f} ({sums['qgs_f']:.4f}); "
        f"K3 {sums['k3']:.4f} ({sums['qk3']:.4f}) ms vs grid_sample backward "
        f"{sums['gs_b']:.4f} ({sums['qgs_b']:.4f}); queued K2 {gbs(sums['bytes'], sums['qk2'])} "
        f"and K3 {gbs(sums['bytes'], sums['qk3'])} GB/s of {HBM_BYTES_PER_S / 1e9:.0f}; "
        f"bounds {sums['b2']:.4f} and {sums['b3']:.4f} ms | {card}")
    return sums, by2, by3


def clock_rates():
    """(float32-pipe, MUFU) instructions per second: the per-clock, per-SM
    rates x the card's SMs x the maximum SM clock that nvidia-smi reports;
    and the SMs and MHz."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_s = sms * mhz * 1e6
    return (FMA_PER_CLOCK_PER_SM * per_s, MUFU_PER_CLOCK_PER_SM * per_s), sms, mhz


def math_costs(tmp):
    """{"exp" | "log" | "div": (float32-pipe, MUFU) instructions} of one
    accurate expf, logf and float32 division on sm_90a: MATH_PROBE built with
    the port's nvcc architecture and -O3, its SASS (cuobjdump -sass) counted
    up to each probe's first EXIT (the fast path: the division's slow-path
    subroutine lies after it), less the copy-only probe's."""
    src, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
    with open(src, "w") as f:
        f.write(MATH_PROBE)
    nvcc = _build._nvcc()
    subprocess.run([nvcc, *_build.NVCC_FLAGS[:4], "-cubin", "-o", cubin, src], check=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name, fma, mufu = part.split()[0], 0, 0
        for line in part.splitlines()[1:]:
            words = line.split("*/", 1)[-1].split()
            words = words[1:] if words and words[0].startswith("@") else words
            if not words or not line.strip().startswith("/*"):
                continue
            op = words[0].split(".")[0]
            if op == "EXIT":
                break
            fma += op in ("FFMA", "FADD", "FMUL")
            mufu += op == "MUFU"
        counts[name] = (fma, mufu)
    none = counts["probe_none"]
    return {k: (counts[f"probe_{k}"][0] - none[0], counts[f"probe_{k}"][1] - none[1])
            for k in ("exp", "log", "div")}


def ot_work(n, d, costs, iters=OT_ITERS):
    """K4's and K5's least work for n pixels of D bins, counted from
    csrc/sinkhorn_ot.cu: (float32-pipe instructions, MUFU instructions,
    bytes).  Per pixel each counts its expf, logf and divisions at `costs`
    (math_costs) and the adds and multiplies written in the source, a
    multiply-add as one FFMA and a sum of D terms as D - 1 adds:
      K4: D logs and D divisions for the marginals and S; an iteration 2 D^2
          exp and 2 D log, 6 D^2 + 2 D adds; the loss D^2 exp and 3 D^2 + D;
          reads D + 1 words and writes 1.
      K5: the replay as K4; the plan D^2 exp and 4 D^2 + 3 D; each of the
          iters steps of the reverse sweep a softmax over rows (D^2 exp and
          D^2 divisions, 4 D^2 + D), each but the last one over columns too
          (the same, 4 D^2 - D); D divisions and D adds for dL/dpred; reads
          pred, gt_idx and g and writes dpred (2 D + 2 words)."""
    def total(explicit, n_exp, n_log, n_div):
        fma = explicit + sum(k * costs[op][0] for k, op in
                             ((n_exp, "exp"), (n_log, "log"), (n_div, "div")))
        mufu = sum(k * costs[op][1] for k, op in ((n_exp, "exp"), (n_log, "log"), (n_div, "div")))
        return n * fma, n * mufu

    sq, sweep = d * d, 2 * iters - 1  # softmaxes in the reverse sweep
    replay = d + iters * (6 * sq + 2 * d)
    k4 = total(replay + 3 * sq + d, iters * 2 * sq + sq, d + iters * 2 * d, d)
    k5 = total(replay + 4 * sq + 3 * d + iters * (4 * sq + d) + (iters - 1) * (4 * sq - d) + d,
               iters * 2 * sq + sq + sweep * sq, d + iters * 2 * d, d + sweep * sq + d)
    return (*k4, 4 * n * (d + 2)), (*k5, 4 * n * (2 * d + 2))


def ot_bound(fma, mufu, nbytes, rates):
    """(ms, "bytes" | "operations"): the least time for the float32-pipe and
    MUFU instructions at the card's instruction rates (clock_rates) and the bytes
    at 3.35 TB/s."""
    by_ops = max(fma / rates[0], mufu / rates[1]) * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def ot_inputs(seed, h, w, d, dev, b=BATCH):
    """gt (B, H, W), hypotheses inverse-uniform over [425, 935] with a +-5%
    per-pixel jitter and a softmax attention (B, D, H, W), mask (B, H, W)
    bool with 80% of the pixels valid, from a numpy seed."""
    rng = np.random.default_rng(seed)
    inv = 1.0 / 935.0 + (1.0 / 425.0 - 1.0 / 935.0) * np.arange(d) / (d - 1)
    hypo = (1.0 / inv)[None, :, None, None] * rng.uniform(0.95, 1.05, size=(b, d, h, w))
    logits = rng.normal(size=(b, d, h, w)) * 3.0
    attn = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    gt = rng.uniform(440, 920, size=(b, h, w))
    mask = torch.from_numpy(rng.uniform(size=(b, h, w)) > 0.2).to(dev)
    return t(gt, dev), t(hypo, dev), t(attn, dev), mask


def _assert_dpred_close(got, want):
    torch.testing.assert_close(got, want, rtol=K5_RTOL,
                               atol=K5_FLOOR * want.abs().max().item())


def phase12_sinkhorn(dev):
    """K4 and K5 against their plain versions at the DTU-mid stage shapes,
    batch 2; returns the max errors and each stage's inputs for phase 15."""
    err4 = err5 = errf = 0.0
    per_stage = []
    for si, (h, w, _, d, _) in enumerate(STAGES):
        gt, hypo, attn, mask = ot_inputs(400 + si, h, w, d, dev)
        pred = attn.reshape(BATCH, d, h * w)
        gt_idx = torch.argmin((hypo - gt[:, None]).abs(), dim=1).reshape(BATCH, h * w).int()
        m = mask.reshape(BATCH, h * w).float()
        g = m / m.sum().clamp(min=1.0)
        loss = sinkhorn_ot.sinkhorn_fwd(pred, gt_idx, OT_ITERS)
        dpred = sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g, OT_ITERS)
        want = sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, OT_ITERS)
        dwant = sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred, gt_idx, g, OT_ITERS)
        torch.cuda.synchronize()
        if not (torch.isfinite(loss).all() and torch.isfinite(dpred).all()):
            raise AssertionError(f"stage{si + 1}: non-finite K4/K5 output")
        torch.testing.assert_close(loss, want, rtol=K4_RTOL, atol=K4_ATOL)
        _assert_dpred_close(dpred, dwant)
        err4 = max(err4, (loss - want).abs().max().item())
        err5 = max(err5, (dpred - dwant).abs().max().item())
        a, b = attn.clone().requires_grad_(), attn.clone().requires_grad_()
        sinkhorn_ot.sinkhorn_loss_fused(gt, hypo, a, mask, OT_ITERS).backward()
        per_pixel = sinkhorn_ot.sinkhorn_pixels_plain(b.reshape(BATCH, d, h * w), gt_idx,
                                                      OT_ITERS)
        ((per_pixel * m).sum() / m.sum().clamp(min=1.0)).backward()
        _assert_dpred_close(a.grad, b.grad)
        errf = max(errf, (a.grad - b.grad).abs().max().item())
        per_stage.append((gt, hypo, attn, mask, pred, gt_idx, g))
    log(f"[12 kernels K4/K5] {len(STAGES)} stages, batch {BATCH}, {OT_ITERS} iterations: "
        f"K4 vs plain max|d| {err4:.3e} (rtol {K4_RTOL}, atol {K4_ATOL}), K5 vs plain "
        f"max|d| {err5:.3e} (rtol {K5_RTOL}, atol {K5_FLOOR} x max|dL/dpred|), Function "
        f"attn.grad vs plain autograd max|d| {errf:.3e}")
    return err4, err5, per_stage


def _reset_counts():
    for fn in (sinkhorn_ot.sinkhorn_fwd, sinkhorn_ot.sinkhorn_bwd, warp_vjp.warp_gather,
               warp_vjp.scatter_grad, warp_correlate.fused_cost_volume):
        fn.launches = 0


def phase13_finetune(dev, tmp, ckpt, card):
    """The BlendedMVS fine-tune through tools.train.main from phase 8's
    checkpoint: the path of the fused Sinkhorn kernels."""
    from mvster_tpu_torch.tools import train

    root = os.path.join(tmp, "blendedmvs")
    t0 = time.perf_counter()
    write_blendedmvs_tree(root, n_views=BLEND_VIEWS, h=BLEND_H, w=BLEND_W)
    tree_s = time.perf_counter() - t0
    logdir = os.path.join(tmp, "log_blend")
    argv = ["--trainpath", root, "--trainlist", f"{root}/train.txt", "--testlist",
            f"{root}/train.txt", "--logdir", logdir, "--loadckpt", ckpt, *BLEND_FLAGS]
    _reset_counts()
    t0 = time.perf_counter()
    result = train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in (
        ("K1", warp_correlate.fused_cost_volume), ("K2", warp_vjp.warp_gather),
        ("K3", warp_vjp.scatter_grad), ("K4", sinkhorn_ot.sinkhorn_fwd),
        ("K5", sinkhorn_ot.sinkhorn_bwd))}
    steps = result["steps"]
    val_batches = -(-BLEND_VIEWS // BATCH)  # one sample per reference view
    views = 4 * (BLEND_VIEWS - 1)
    expect = dict(K1=4 * val_batches, K2=views * steps, K3=views * steps,
                  K4=4 * steps + 4 * val_batches, K5=4 * steps)
    if steps != BLEND_VIEWS // BATCH or launches != expect:
        raise AssertionError(f"{steps} steps, launches {launches}, expected {expect}")
    records = _jsonl(os.path.join(logdir, "metrics.jsonl"))
    for r in records:
        for key in ("loss", "epe", "err1", "err3"):
            if not np.isfinite(r[key]):
                raise AssertionError(f"{r['mode']} {key} = {r[key]}")
    train_recs = [r for r in records if r["mode"] == "train"]
    val = [r for r in records if r["mode"] == "fulltest"]
    if len(train_recs) != steps or len(val) != 1:
        raise AssertionError(f"{len(train_recs)} train and {len(val)} val records")
    config = MVS4NetConfig.dtu_default()
    start = load_reference_ckpt(ckpt, config)
    tuned = load_reference_ckpt(result["checkpoint"], config)
    params = {name for name, _ in MVS4Net(config).named_parameters()}
    moved = {k for k in params if not torch.equal(tuned[k], start[k])}
    expect_moved = {k for k in params if not k.startswith("mono_depth_decoder.")}
    if moved != expect_moved:
        raise AssertionError(f"moved parameters differ: {sorted(moved ^ expect_moved)[:8]}")
    log(f"[13 fine-tune] tools.train.main --dataset blendedmvs --ot_backend pallas from "
        f"phase 8's checkpoint: {steps} steps of batch {BATCH} at {BLEND_H}x{BLEND_W}, "
        f"{BLEND_VIEWS} views + a val pass of {val_batches} batches in {train_s:.1f} s "
        f"(tree written in {tree_s:.1f} s); loss {train_recs[0]['loss']:.3f} -> "
        f"{train_recs[-1]['loss']:.3f}, EPE {train_recs[-1]['epe']:.3f}, err1 "
        f"{train_recs[-1]['err1']:.2f}%, err3 {train_recs[-1]['err3']:.2f}%; val loss "
        f"{val[0]['loss']:.3f}, EPE {val[0]['epe']:.3f}; launches {launches} (per step "
        f"4 K4, 4 K5, {views} K2, {views} K3; per val batch 4 K1, 4 K4); {len(moved)} of "
        f"{len(params)} parameter tensors moved | {card}")
    return launches, root


@contextlib.contextmanager
def plain_warp():
    """Within: the training cost volume gathers with the plain warp (autograd
    through warp_plain), which takes any dtype: the float64 reference step."""
    kernel = warp_vjp.grid_sample_zeros_vjp
    warp_vjp.grid_sample_zeros_vjp = warp_vjp.warp_plain
    try:
        yield
    finally:
        warp_vjp.grid_sample_zeros_vjp = kernel


def dtu_batch(root, dev):
    """The first batch of the DTU tree's training loader, on the device."""
    from mvster_tpu_torch.data import MVSLoader
    from mvster_tpu_torch.data.dtu import DTUDataset
    from mvster_tpu_torch.train.loop import device_batch

    ds = DTUDataset(root, f"{root}/train.txt", "train", NVIEWS, 1.06, seed=1)
    return device_batch(next(iter(MVSLoader(ds, BATCH, prefetch=0))), dev)


def phase14_backends(dev, root):
    """ot_backend pallas against xla on one DTU-mid train step."""
    config = MVS4NetConfig.dtu_default()
    sd = init_state_dict(MVS4Net(config), seed=1)
    batch = dtu_batch(root, dev)
    runs = {}
    for name, backend, dtype in (("pallas", "pallas", torch.float32),
                                 ("xla", "xla", torch.float32),
                                 ("exact", "xla", torch.float64)):
        model = MVS4Net(config)
        model.load_state_dict(sd, strict=True)
        model.to(device=dev, dtype=dtype)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                               loss_kwargs=dict(LOSS_KW, ot_backend=backend))
        b = batch
        if dtype == torch.float64:
            b = {k: ({s: x.double() for s, x in v.items()} if isinstance(v, dict)
                     else v.double()) for k, v in batch.items()}
            with plain_warp():
                scalars, _ = step(b)
        else:
            scalars, _ = step(b)
        runs[name] = dict(ot=[float(scalars[f"s{i}_c_loss"]) for i in range(4)],
                          grads={k: p.grad.double().cpu().numpy()
                                 for k, p in model.named_parameters()})
        del model, step
        torch.cuda.empty_cache()
    np.testing.assert_allclose(runs["pallas"]["ot"], runs["xla"]["ot"], rtol=1e-5)
    worst, worst_key, checked = 0.0, "", 0
    for key, g_x in runs["xla"]["grads"].items():
        g_p, g_e = runs["pallas"]["grads"][key], runs["exact"]["grads"][key]
        if np.linalg.norm(g_e) < GRAD_NOISE:  # zero in exact arithmetic
            np.testing.assert_allclose(g_p, g_x, atol=GRAD_NOISE, err_msg=key)
            continue
        # check_grads' rule: each float32 gradient as close to the float64
        # one as the other's (within 10x, or 1e-4), and the two within 1.5x
        # their summed float32 noise (or 1e-4)
        e_p, e_x = relative_l2(g_p, g_e), relative_l2(g_x, g_e)
        rel = relative_l2(g_p, g_x)
        if (e_p > max(1e-4, 10 * e_x) or e_x > max(1e-4, 10 * e_p)
                or rel > max(1e-4, 1.5 * (e_p + e_x))):
            raise AssertionError(f"{key}: pallas vs xla relative L2 {rel:.2e}; against "
                                 f"float64 pallas {e_p:.2e}, xla {e_x:.2e}")
        checked += 1
        if rel > worst:
            worst, worst_key = rel, key
    log(f"[14 backends] DTU-mid train step, batch {BATCH}: per-stage OT loss pallas "
        + ", ".join(f"{p:.6f}" for p in runs["pallas"]["ot"]) + " vs xla "
        + ", ".join(f"{x:.6f}" for x in runs["xla"]["ot"]) + f" (rtol 1e-5); {checked} "
        f"gradient tensors within their float32 noise of a float64 step: worst pallas vs "
        f"xla relative L2 {worst:.2e} ({worst_key})")
    return batch


def train_step_fn(dev, loss_fn, backend, batch):
    """A train step of dtu_default() from tools.train's initial weights
    (seed 1), Adam at 1e-3, on `batch`: called with no arguments."""
    config = MVS4NetConfig.dtu_default()
    model = MVS4Net(config)
    model.load_state_dict(init_state_dict(model, seed=1), strict=True)
    model.to(dev)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), loss_fn,
                           dict(LOSS_KW, ot_backend=backend))
    return lambda: step(batch)


def phase15_times(dev, per_stage, dtu, blend_root, card, rates, costs):
    """K4/K5 per stage against plain and the xla backend; the train steps."""
    from mvster_tpu_torch.data import MVSLoader
    from mvster_tpu_torch.data.blendedmvs import BlendedMVSDataset
    from mvster_tpu_torch.models.losses import _sinkhorn_loss, blend_loss, mvs4net_loss
    from mvster_tpu_torch.train.loop import device_batch

    sums = dict(k4=0.0, k5=0.0, p4=0.0, p5=0.0, xla=0.0, fused=0.0, b4=0.0, b5=0.0)
    by4 = by5 = "operations"
    for si, (gt, hypo, attn, mask, pred, gt_idx, g) in enumerate(per_stage):
        h, w, _, d, _ = STAGES[si]
        a = attn.clone().requires_grad_()

        def loss_fb(backend):
            def run():
                _sinkhorn_loss(gt, hypo, a, mask, OT_ITERS, 1.0, False, backend).backward()
            return run

        fns = dict(
            k4=lambda: sinkhorn_ot.sinkhorn_fwd(pred, gt_idx, OT_ITERS),
            k5=lambda: sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g, OT_ITERS),
            p4=lambda: sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, OT_ITERS),
            p5=lambda: sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred, gt_idx, g, OT_ITERS),
            xla=loss_fb("xla"), fused=loss_fb("pallas"),
        )
        order = ["p4", "k4", "p5", "k5", "xla", "fused"]
        times = {k: [] for k in fns}
        for name in order + order[::-1]:
            times[name].append(cuda_ms(fns[name], iters=10))
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        (f4, s4, n4), (f5, s5, n5) = ot_work(BATCH * h * w, d, costs)
        b4, by4 = ot_bound(f4, s4, n4, rates)
        b5, by5 = ot_bound(f5, s5, n5, rates)
        for k in ms:
            sums[k] += ms[k]
        sums["b4"] += b4
        sums["b5"] += b5
        log(f"[15 times] stage{si + 1} {(h, w)} D={d} B={BATCH}: K4 {ms['k4']:.4f} ms (plain "
            f"{ms['p4']:.4f}, bound {b4:.4f} by {by4}: {f4:.4e} float32-pipe and {s4:.4e} "
            f"MUFU instructions); K5 {ms['k5']:.4f} ms (plain {ms['p5']:.4f}, bound {b5:.4f}: "
            f"{f5:.4e} float32-pipe, {s5:.4e} MUFU); loss forward+backward: pallas (K4+K5) "
            f"{ms['fused']:.4f} ms, xla (checkpointed plain) {ms['xla']:.4f} ms | {card}")
    log(f"[15 times] over the four stages: K4 {sums['k4']:.4f} ms (plain {sums['p4']:.4f}, "
        f"bound {sums['b4']:.4f}), K5 {sums['k5']:.4f} ms (plain {sums['p5']:.4f}, bound "
        f"{sums['b5']:.4f}); loss forward+backward pallas {sums['fused']:.4f} ms vs xla "
        f"{sums['xla']:.4f} ms | {card}")

    steps = {b: train_step_fn(dev, mvs4net_loss, b, dtu) for b in ("xla", "pallas")}
    for fn in steps.values():
        fn()
        fn()
    step_ms = {b: [] for b in steps}
    for b in ("xla", "pallas", "pallas", "xla"):
        step_ms[b].append(cuda_ms(steps[b], iters=5, warmup=0))
    del steps
    torch.cuda.empty_cache()
    log(f"[15 times] DTU-mid train step, batch {BATCH} (mean of 5, in turns xla, pallas, "
        f"pallas, xla): pallas " + " / ".join(f"{x:.2f}" for x in step_ms["pallas"])
        + " ms, xla " + " / ".join(f"{x:.2f}" for x in step_ms["xla"]) + f" ms | {card}")

    ds = BlendedMVSDataset(blend_root, f"{blend_root}/train.txt", "train", BLEND_VIEWS,
                           robust_train=False)
    batch = device_batch(next(iter(MVSLoader(ds, BATCH, prefetch=0))), dev)
    blend = train_step_fn(dev, blend_loss, "pallas", batch)
    blend()
    blend()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blend_ms = cuda_ms(blend, iters=3, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    log(f"[15 times] BlendedMVS train step ({BLEND_H}x{BLEND_W}, {BLEND_VIEWS} views, batch "
        f"{BATCH}, blend_loss, pallas, mean of 3 after 2 warm-up) {blend_ms:.2f} ms; peak "
        f"memory {peak / 2**30:.3f} GiB | {card}")
    return sums, by4, by5


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
    k1_bounds = [bound(*k1_work(*st)) for st in STAGES]
    k1_bound = sum(b for b, _ in k1_bounds)
    log(f"[6 times] K1 bound {k1_bound:.4f} ms over the four stages ("
        + ", ".join(f"s{i + 1} {b * 1e3:.1f} us by {by}" for i, (b, by) in enumerate(k1_bounds))
        + ")")

    # 7-11: the training path; 12-15: the fused Sinkhorn loss and the
    # BlendedMVS fine-tune
    err2, err3, per_stage = phase7_kernels(dev)
    err4, err5, ot_stages = phase12_sinkhorn(dev)
    rates, sms, mhz = clock_rates()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        costs = math_costs(tmp)
        k2_launches, k3_launches, root, ckpt = phase8_train(dev, tmp, card)
        phase9_card_vs_cpu(dev)
        phase10_learns(dev)
        sums, by2, by3 = phase11_times(dev, root, per_stage, card)
        ft_launches, blend_root = phase13_finetune(dev, tmp, ckpt, card)
        dtu = phase14_backends(dev, root)
        ot_sums, by4, by5 = phase15_times(dev, ot_stages, dtu, blend_root, card, rates, costs)
    log(f"[15 times] K4/K5 bounds at {FMA_PER_CLOCK_PER_SM} float32-pipe and "
        f"{MUFU_PER_CLOCK_PER_SM} MUFU instructions a clock x {sms} SMs x {mhz:.0f} MHz "
        f"(nvidia-smi's maximum SM clock) = {rates[0]:.4e} and {rates[1]:.4e} per s; "
        f"(float32-pipe, MUFU) instructions from SASS: " + ", ".join(
            f"{k} {v}" for k, v in costs.items()))

    print(card)
    print(json.dumps({"kernels": [
        dict(KERNEL, launches=main_path_launches, max_abs_err=max(errs), ms=k_total,
             plain_ms=p_total, bound_ms=k1_bound, bound_by=k1_bounds[-1][1],
             library_ms=None, wrapper_ms=w_total),
        dict(K2, launches=k2_launches, max_abs_err=err2, ms=sums["qk2"],
             plain_ms=sums["p2"], bound_ms=sums["b2"], bound_by=by2,
             library_ms=sums["qgs_f"], back_to_back_ms=sums["k2"]),
        dict(K3, launches=k3_launches, max_abs_err=err3, ms=sums["qk3"],
             plain_ms=sums["p3"], bound_ms=sums["b3"], bound_by=by3,
             library_ms=sums["qgs_b"], back_to_back_ms=sums["k3"]),
        dict(K4, launches=ft_launches["K4"], max_abs_err=err4, ms=ot_sums["k4"],
             plain_ms=ot_sums["p4"], bound_ms=ot_sums["b4"], bound_by=by4,
             library_ms=None),
        dict(K5, launches=ft_launches["K5"], max_abs_err=err5, ms=ot_sums["k5"],
             plain_ms=ot_sums["p5"], bound_ms=ot_sums["b5"], bound_by=by5,
             library_ms=None),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
