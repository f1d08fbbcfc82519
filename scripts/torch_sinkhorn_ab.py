"""Time an older build of K4/K5 (the Sinkhorn OT kernels) against the tree's, in turns on one card.

    git show <commit>:mvster_tpu_torch/csrc/sinkhorn_ot.cu > build/old_sinkhorn_ot.cu
    python3 scripts/torch_sinkhorn_ab.py build/old_sinkhorn_ot.cu [--json out.json]
        [--nvcc-flag=-fmad=false] [--sass DIR]

The older source and the tree's csrc/sinkhorn_ot.cu are each built alone
with the port's nvcc flags (and any --nvcc-flag: -fmad=false shows whether
two builds that differ only in where nvcc fuses multiply-adds sum in the
same order); the older one must have the C interface of the
one-thread-a-pixel design:
mvster_sinkhorn_fwd(pred, gt_idx, loss, B, N, D, iters, eps, maxd, stream)
and mvster_sinkhorn_bwd(pred, gt_idx, g, dpred, B, N, D, iters, eps,
threads, smem_bytes, maxd, stream).  At the four DTU-mid stages (batch 2,
10 iterations, chip_smoke.py phase 12's inputs) and at other depth counts
at 64x80, it prints both builds' K4 and K5 times, queued behind a spin of
the card and back to back, in turns old, new, new, old; the bound
(chip_smoke.ot_work) and each time's share of it; whether the two K5s agree
bitwise and K4's largest difference, both held to the plain versions at
chip_smoke.py's tolerances; and each build's registers and stack frames of
the Sinkhorn kernels from ptxas (--sass DIR: their SASS too).  Needs one
NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from mvster_tpu_torch.kernels import _build, sinkhorn_ot  # noqa: E402

OFF_D = [2, 3, 5, 16, 32]  # at 64x80, beside the DTU-mid stages


def build(src, tmp, name, flags, sass_dir=None):
    """One source as a shared library, and ptxas's report; its SASS into
    sass_dir."""
    lib = os.path.join(tmp, f"lib{name}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    if sass_dir:
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        with open(os.path.join(sass_dir, f"sass_{name}.txt"), "w") as f:
            subprocess.run([cuobjdump, "-sass", lib], stdout=f, check=True)
    lib = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "old":
        lib.mvster_sinkhorn_fwd.argtypes = [p, p, p, i, i, i, i, f, i, p]
        lib.mvster_sinkhorn_bwd.argtypes = [p, p, p, p, i, i, i, i, f, i, i, i, p]
    else:  # as kernels/_build.py declares them
        lib.mvster_sinkhorn_fwd.argtypes = [p, p, p, i, i, i, i, f, i, i, i, p]
        lib.mvster_sinkhorn_bwd.argtypes = [p, p, p, p, i, i, i, i, f, i, i, i, i, p]
    return lib, proc.stdout + proc.stderr


def ptxas_report(log):
    """{kernel: (registers, stack frame bytes, spill store bytes)} of the
    Sinkhorn kernels in a ptxas -v log, names demangled where c++filt is."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    names = [n for n in out if "sinkhorn" in n]
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        plain = names
    return {p.replace("(anonymous namespace)::", ""): tuple(out[n]) for n, p in zip(names, plain)}


def old_plan(d, iters):
    """The older design's capacity and K5 block: the smallest of 4, 8, 16,
    32, 64 that holds D; the largest of 128, 64, 32 threads whose (iters,
    2, D) history fits in 48 KB, else 32."""
    cap = next(m for m in (4, 8, 16, 32, 64) if d <= m)
    per_thread = iters * 2 * d * 4
    threads = next((n for n in (128, 64, 32) if per_thread * n <= 48 * 1024), 32)
    return cap, threads, per_thread * threads


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_source")
    ap.add_argument("--json", default=None, help="write the results here too")
    ap.add_argument("--nvcc-flag", action="append", default=[],
                    help="an nvcc flag for both builds (repeatable)")
    ap.add_argument("--sass", default=None, help="write both builds' SASS here")
    ap.add_argument("--shapes", default=None,
                    help="HxWxD,... to time instead of the DTU-mid stages and OFF_D at 64x80")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sinkhorn_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    rates, sms, mhz = cs.clock_rates()
    new_src = str(_build.CSRC_DIR / "sinkhorn_ot.cu")
    with tempfile.TemporaryDirectory(prefix="sinkhorn_ab_") as tmp:
        old, old_log = build(args.old_source, tmp, "old", args.nvcc_flag, args.sass)
        new, new_log = build(new_src, tmp, "new", args.nvcc_flag, args.sass)
        costs = cs.math_costs(tmp)
    regs = {"old": ptxas_report(old_log), "new": ptxas_report(new_log)}
    for which, rep in regs.items():
        for name, (nreg, stack, spill) in sorted(rep.items()):
            print(f"[ptxas {which}] {name}: {nreg} registers, {stack} B stack frame, "
                  f"{spill} B spill stores", flush=True)

    it = cs.OT_ITERS
    shapes = [(h, w, d, 400 + si) for si, (h, w, _, d, _) in enumerate(cs.STAGES)]
    shapes += [(64, 80, d, 600 + i) for i, d in enumerate(OFF_D)]
    if args.shapes:
        shapes = [(*map(int, x.split("x")), 700 + i) for i, x in enumerate(args.shapes.split(","))]
    rows = []
    for h, w, d, seed in shapes:
        gt, hypo, attn, mask = cs.ot_inputs(seed, h, w, d, dev)
        n = h * w
        pred = attn.reshape(cs.BATCH, d, n)
        gt_idx = torch.argmin((hypo - gt[:, None]).abs(), dim=1).reshape(cs.BATCH, n).int()
        m = mask.reshape(cs.BATCH, n).float()
        g = m / m.sum().clamp(min=1.0)
        cap, threads, smem = old_plan(d, it)
        loss_old = torch.empty(cs.BATCH, n, device=dev)
        dpred_old = torch.empty(cs.BATCH, d, n, device=dev)

        def old_fwd():
            stream = torch.cuda.current_stream().cuda_stream
            rc = old.mvster_sinkhorn_fwd(pred.data_ptr(), gt_idx.data_ptr(), loss_old.data_ptr(),
                                         cs.BATCH, n, d, it, 1.0, cap, stream)
            if rc:
                raise RuntimeError(f"old mvster_sinkhorn_fwd: cudaError {rc}")

        def old_bwd():
            stream = torch.cuda.current_stream().cuda_stream
            rc = old.mvster_sinkhorn_bwd(pred.data_ptr(), gt_idx.data_ptr(), g.data_ptr(),
                                         dpred_old.data_ptr(), cs.BATCH, n, d, it, 1.0,
                                         threads, smem, cap, stream)
            if rc:
                raise RuntimeError(f"old mvster_sinkhorn_bwd: cudaError {rc}")

        plan4 = sinkhorn_ot.plan_launch("fwd", d, it, cs.BATCH * n)
        plan = sinkhorn_ot.plan_launch("bwd", d, it, cs.BATCH * n)
        loss = torch.empty(cs.BATCH, n, device=dev)
        dpred = torch.empty(cs.BATCH, d, n, device=dev)

        def new_fwd():
            stream = torch.cuda.current_stream().cuda_stream
            rc = new.mvster_sinkhorn_fwd(pred.data_ptr(), gt_idx.data_ptr(), loss.data_ptr(),
                                         cs.BATCH, n, d, it, 1.0,
                                         sinkhorn_ot.DESIGNS.index(plan4.design),
                                         plan4.capacity, plan4.threads, stream)
            if rc:
                raise RuntimeError(f"new mvster_sinkhorn_fwd: cudaError {rc}")

        def new_bwd():
            stream = torch.cuda.current_stream().cuda_stream
            rc = new.mvster_sinkhorn_bwd(pred.data_ptr(), gt_idx.data_ptr(), g.data_ptr(),
                                         dpred.data_ptr(), cs.BATCH, n, d, it, 1.0,
                                         sinkhorn_ot.DESIGNS.index(plan.design), plan.capacity,
                                         plan.threads, plan.smem, stream)
            if rc:
                raise RuntimeError(f"new mvster_sinkhorn_bwd: cudaError {rc}")

        fns = dict(old4=old_fwd, new4=new_fwd, old5=old_bwd, new5=new_bwd)
        for fn in fns.values():
            fn()
        want = sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, it)
        dwant = sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred, gt_idx, g, it)
        torch.cuda.synchronize()
        for got4, got5 in ((loss, dpred), (loss_old, dpred_old)):
            torch.testing.assert_close(got4, want, rtol=cs.K4_RTOL, atol=cs.K4_ATOL)
            cs._assert_dpred_close(got5, dwant)
        q = {k: [] for k in fns}
        b2b = {k: [] for k in fns}
        for name in ("old4", "new4", "new4", "old4", "old5", "new5", "new5", "old5"):
            q[name].append(cs.queued_ms(fns[name], iters=20))
            b2b[name].append(cs.cuda_ms(fns[name], iters=20))
        q = {k: sum(v) / len(v) for k, v in q.items()}
        b2b = {k: sum(v) / len(v) for k, v in b2b.items()}
        (f4, s4, n4), (f5, s5, n5) = cs.ot_work(cs.BATCH * n, d, costs)
        bound = {"4": cs.ot_bound(f4, s4, n4, rates)[0], "5": cs.ot_bound(f5, s5, n5, rates)[0]}
        row = dict(h=h, w=w, d=d, design=(plan4.design, plan.design), nvcc_flags=args.nvcc_flag,
                   queued_ms=q, back_to_back_ms=b2b, bound_ms=bound,
                   k5_bitwise=bool(torch.equal(dpred, dpred_old)),
                   k5_max_abs_diff=(dpred - dpred_old).abs().max().item(),
                   k4_max_abs_diff=(loss - loss_old).abs().max().item())
        rows.append(row)
        print(f"[ab] {h}x{w} D={d} B={cs.BATCH}, new K4 {plan4.design}, K5 {plan.design}: K4 old {q['old4']:.4f} new {q['new4']:.4f} ms "
              f"queued (back to back {b2b['old4']:.4f} / {b2b['new4']:.4f}), bound "
              f"{bound['4']:.4f}: {100 * bound['4'] / q['old4']:.1f}% -> "
              f"{100 * bound['4'] / q['new4']:.1f}%; K5 old {q['old5']:.4f} new {q['new5']:.4f} "
              f"({b2b['old5']:.4f} / {b2b['new5']:.4f}), bound {bound['5']:.4f}: "
              f"{100 * bound['5'] / q['old5']:.1f}% -> {100 * bound['5'] / q['new5']:.1f}%; K5 "
              f"bitwise {row['k5_bitwise']} (max|d| {row['k5_max_abs_diff']:.3e}), K4 max|d| "
              f"{row['k4_max_abs_diff']:.3e} | {card}", flush=True)
    stages = rows[:len(cs.STAGES)] if not args.shapes else rows
    total = {k: sum(r["queued_ms"][k] for r in stages) for k in fns}
    total.update({"bound4": sum(r["bound_ms"]["4"] for r in stages),
                  "bound5": sum(r["bound_ms"]["5"] for r in stages)})
    print(f"[ab] {'the given shapes' if args.shapes else 'the four DTU-mid stages'}, queued: K4 old {total['old4']:.4f} new "
          f"{total['new4']:.4f} ms (bound {total['bound4']:.4f}), K5 old {total['old5']:.4f} new "
          f"{total['new5']:.4f} ms (bound {total['bound5']:.4f}); bounds at {sms} SMs x "
          f"{mhz:.0f} MHz; extra nvcc flags {args.nvcc_flag} | {card}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, rows=rows, total=total, ptxas=regs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
