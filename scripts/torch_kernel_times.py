"""K4/K5, K6 and K7 alone on the card, each beside its least time.

No traced cell reads these alone yet: dtu-mid-train runs the plain
Sinkhorn (--ot_backend xla), so `k4_roofline` and `k5_roofline` read
blendedmvs-train's stages only; a train cell's `nn.wgrad_ms.train` sums
every weight-gradient kernel (cuDNN's with K6's), and a --dcn serve cell's
`nn.dcn_ms.serve` and `dcn_roofline` the whole of each DCN head (its two
convs, BatchNorm, ReLU, the copies and K7).  This script times them until
the benchmark reads each:

    python scripts/torch_kernel_times.py [--out FILE]

K4 and K5 at the four DTU-mid stages, batch 2, 10 iterations
(tests/test_torch_sinkhorn_ot.py's CARD_SHAPES), summed a step, their
least time mvsbench.work's; K6 at every planar conv of the two train
cells' steps and two band shapes (tests/test_torch_conv_wgrad.py's
TRAIN_CONVS), summed by cell; K7 at the four heads of a served --dcn view
(tests/test_torch_deform_conv_cuda.py's SERVED_HEADS, 5 images) with
offsets of N(0, 1) and N(0, 64^2) px, summed a view, alone and with the
wrapper's channels-last copy.  K6's and K7's least times are
mvsbench.work.bound_s of the bytes and FLOPs counted below.  Each time is
CUDA events over 20 calls queued behind a 50 ms spin of the card, so the
host's dispatch is not timed.  Prints one JSON line (also to FILE):
{"device", "power_limit", "kernels": {name: {"ms", "bound_ms",
"roofline_pct"}}}.  The script needs a CUDA card; it imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

SPIN_S = 50e-3
SPIN_CYCLES = int(SPIN_S * 1.98e9)  # ~50 ms at the H100's 1980 MHz
CALLS = 20


def queued_ms(fn):
    """Device ms a call of fn, its calls queued behind a spin of the card."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    if host_s > 0.8 * SPIN_S:
        raise RuntimeError(f"queueing {CALLS} calls took {host_s * 1e3:.1f} ms of host time")
    return start.elapsed_time(end) / CALLS


def k45_times(dev):
    """{"k4"|"k5": (ms, least ms)} summed over the DTU-mid stages."""
    from mvsbench.work import ot_bound_s, ot_work
    from mvster_tpu_torch.kernels import sinkhorn_ot
    from test_torch_sinkhorn_ot import CARD_SHAPES, _card_inputs

    sums = {"k4": [0.0, 0.0], "k5": [0.0, 0.0]}
    for h, w, d in CARD_SHAPES:
        pred, gt_idx, g = _card_inputs((h, w, d), dev)
        k4, k5 = ot_work(pred.shape[0] * h * w, d, 10)
        for name, fn, work in (("k4", lambda: sinkhorn_ot.sinkhorn_fwd(pred, gt_idx, 10), k4),
                               ("k5", lambda: sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g, 10), k5)):
            sums[name][0] += queued_ms(fn)
            sums[name][1] += ot_bound_s(*work) * 1e3
    return sums


def k6_times(dev):
    """{cell: (K6 ms, least ms)} summed over the cell's planar convs.  A
    conv's bytes: g, x and the weight gradient once; FLOPs: 2 M C 9 a
    pixel of g."""
    from mvsbench.work import bound_s
    from mvster_tpu_torch.kernels import conv_wgrad
    from test_torch_conv_wgrad import TRAIN_CONVS

    gen = torch.Generator(device=dev).manual_seed(25)
    sums = {}
    for name, _, m, c, stride, padding, gs, xs in TRAIN_CONVS:
        g = torch.randn(gs, generator=gen, device=dev)
        x = torch.randn(xs, generator=gen, device=dev)
        ms = queued_ms(lambda: conv_wgrad.conv_wgrad(g, x, stride, padding))
        b, _, d, ho, wo = gs
        least = bound_s(4 * (g.numel() + x.numel() + m * c * 9), 2 * m * c * 9 * b * d * ho * wo)
        cell = name.split(".")[0]
        total = sums.setdefault(cell, [0.0, 0.0])
        total[0] += ms
        total[1] += least * 1e3
    return sums


def k7_times(dev):
    """{reach: (K7 ms, K7 with its copy ms, least ms)} summed over a view's
    four heads.  A head's bytes: the map, 27 offset and mask floats a pixel
    and the output once; FLOPs: 18 C^2 of contraction and 72 C of sampling
    a pixel."""
    from mvsbench.work import bound_s
    from mvster_tpu_torch.kernels import deform_conv as dc
    from test_torch_deform_conv_cuda import SERVED_HEADS, _inputs

    lib = dc.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sums = {}
    for reach in (1.0, 64.0):
        total = sums.setdefault(f"{reach:g}px", [0.0, 0.0, 0.0])
        for c, h, w in SERVED_HEADS:
            n = 5
            x, off, mask, wt = _inputs(c, h, w, reach, seed=c + int(reach), b=n)
            with torch.inference_mode():
                dc.deform_conv(x, off, mask, wt)  # sets K7's shared-memory attribute
                x_last = x.permute(0, 2, 3, 1).contiguous()
                out = torch.empty(n, c, h, w, device=dev)

                def alone():
                    rc = lib.mvster_deform_conv(x_last.data_ptr(), off.data_ptr(),
                                                mask.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                                n, c, h, w, h, 0, stream)
                    if rc:
                        raise RuntimeError(f"mvster_deform_conv returned {rc}")

                total[0] += queued_ms(alone)
                total[1] += queued_ms(lambda: dc.deform_conv(x, off, mask, wt))
            pixels = n * h * w
            total[2] += bound_s(pixels * (8 * c + 4 * 27), pixels * (18 * c * c + 72 * c)) * 1e3
    return sums


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", help="also write the JSON line to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip().splitlines()
    kernels = {}
    for name, (ms, least) in k45_times(dev).items():
        kernels[f"{name}.dtu-mid"] = {"ms": ms, "bound_ms": least, "roofline_pct": 100 * least / ms}
    for cell, (ms, least) in k6_times(dev).items():
        kernels[f"k6.{cell}"] = {"ms": ms, "bound_ms": least, "roofline_pct": 100 * least / ms}
    for reach, (ms, with_copy, least) in k7_times(dev).items():
        kernels[f"k7.{reach}"] = {"ms": ms, "with_copy_ms": with_copy, "bound_ms": least,
                                  "roofline_pct": 100 * least / ms}
    line = json.dumps({"device": torch.cuda.get_device_name(dev),
                       "power_limit": limit[0] if limit else None, "kernels": kernels})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
