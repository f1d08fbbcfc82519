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
  6. times: the steady-state forward by CUDA events and a torch.profiler
     breakdown of it (device busy, launches, K1's share); per stage, in
     turns, K1 queued behind a spin of the card and back to back, K1 with
     its rot/trans glue (what the forward calls), the plain version, the
     bound and the launch's blocks
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
 15. times: per stage K4 and K5 (queued behind a spin of the card and back
     to back) beside their bound and its share, their plain versions and
     both backends' loss forward+backward; the DTU-mid train step with
     pallas and with xla; the BlendedMVS step and its peak memory; CUDA
     events, in turns
 16. off-default counts: K1 against plain at 64x80, C=64, (D, G) in
     (2, 2), (3, 2), (16, 16), both attention modes (atol/rtol 1e-4); K4/K5
     against plain at D in 1, 2, 3, 5, 16, 31, 32, 33, 64 at 64x80 and at
     31x37, and at D <= 8 at 256x320 (phase 12's tolerances), each timed
     queued at 64x80 against its bound; an eval
     forward at 128x192, 3 views, stage_splits (16, 8, 4, 4) and
     group_cor_dim (16, 8, 4, 2) against the CPU plain path by the stage
     comparator, with 4 K1 launches; and a train step of that model with
     ot_backend pallas (4 K4, 4 K5 launches) against xla, per-stage OT
     losses at rtol 1e-5
 17. DTU scan: tools.test.main on a synthetic 7-view scan of a textured
     plane at DTU's 1200x1600 (the CLI's default --max_h 864 --max_w 1152
     read it at 832x1152, snapped to multiples of 64), 5 views a
     forward, thres_view 4, conf 0.5, from phase 8's checkpoint, with
     --dtu_gt_dir pointing at a synthetic SampleSet tree of the plane: 28
     K1 launches, 7 finite depth and confidence maps, the mask PNGs, the
     fused PLY and dtu_metrics.json with its keys (its numbers read NaN:
     the checkpoint predicts no depth on the plane; phase 18 scores);
     the seconds of the scan's forward, fusion and metric; then K1
     against plain at that forward's four stage shapes (104x144 to
     832x1152, 4 sources), both attention modes, atol/rtol 1e-4; then
     save_depth's loop over the scan with infer_views' dispatch-ahead
     against one model(...) call per chunk in sequence: the wall time of
     each in turns, the card's busy share of each under torch.profiler,
     and with cuDNN's deterministic algorithms every view's depth and
     confidence bitwise equal
 18. fusion, card vs CPU: geometric_filter on the card and on the CPU
     over phase 17's scan, (a) the plane's analytic depth maps at
     confidence 1 and (b) the predicted maps: masks equal but at pixels
     within 1e-4 of a threshold (counted), depth_avg at rtol 1e-5
     elsewhere; each device's cloud unprojected from its outputs, and
     fuse_scene on the card equal to the card's cloud; (a) the fused
     points on the plane (|z - z0| / z0 < 1e-3) and evaluate_dtu on the
     card's cloud finite with an accuracy under 0.2 mm; |dOverall|
     between the card's and the CPU's clouds; geometric_filter by CUDA
     events and the metric's seconds
 19. Tanks: tools.test.main --dataset tanks --split intermediate over the 8
     scans, 3 views each at 1920x1080, thres_view 1: 96 K1 launches and 8
     fused PLYs; then K1 against plain at that forward's four stage shapes
     (128x240 to 1024x1920, 2 sources), both attention modes, atol/rtol 1e-4
 20. data parallel: (a) `python -m torch.distributed.run --standalone
     --nproc_per_node 1 -m chip_smoke --ddp-entry ...`, whose process runs
     tools.train.main under torchrun's environment (the code path of
     `-m mvster_tpu_torch.tools.train`) at DTU-mid, dtu_default(), 5 views,
     global batch 2, --ot_backend pallas, one epoch on phase 8's tree: the
     group is NCCL of world 1; 16 K2, 16 K3, 4 K4 and 4 K5 launches a step
     and 4 K1 and 4 K4 a val batch; the checkpoint has no `module.` keys,
     loads strictly into a one-process model and serves a request through
     K1; then the DDP-wrapped step against the unwrapped one in that
     process, in turns (CUDA events).  (b) two processes on the one card
     over gloo (`--gloo-rank`), batch 2 each (global 4; rank 1's masks
     halved, so the ranks' counts differ), --ot_backend pallas, one SGD
     step, against one process's batch-4 step on the card: loss and every
     scalar at rtol 1e-5 (the pixel fractions, range_err_ratio and the
     thresholds, at atol 1e-4 more: values within float32 rounding of a
     threshold), parameters at rtol 1e-2 / atol 1e-5, BatchNorm
     running statistics bitwise equal across the ranks and at rtol 1e-4 /
     atol 1e-5 against the one process; each rank's step times and peak
     memory (gloo on one card: not a DDP speed)
 21. model variants: each of tests/_torch_parity.VARIANTS (reg3d; the cam,
     dcam, pam and pdam blocks; the sine and learned depth encodings;
     asff; the convnext and convnext4 pyramids; dcn; bf16 compute) with
     seeded random weights at dtu_default's widths: (a) infer_views
     answers 2 requests at 512x640, 5 views, 4 K1 launches each (and 4 K7
     with dcn), finite depth, stage 1 inside [dmin, dmax]; (b) the same model at 128x192, 3
     views, on the card against the CPU plain path by the stage comparator
     (bf16: assert_bf16_close, the CPU tests' bf16 criteria); (c) one
     dist/train_step step at 512x640, 5 views, batch 2, --ot_backend
     pallas: finite loss, every parameter with a gradient moved, 16 K2, 16
     K3, 4 K4 and 4 K5 launches (and 4 K7 with dcn: K7's forward, its
     plain version's gradients).  Then tools.train.main --reg_mode reg3d
     --pos_enc 2 --ASFF --ot_backend pallas, one epoch of phase 8's tree (16
     K2, 16 K3 and 4 K5 launches a step; its checkpoint loads strictly into
     the variant), and tools.test.main --compute_dtype bfloat16 on phase
     17's scan (28 K1 launches, 7 finite depth maps); and the bf16 and
     float32 forward (20 iterations) and train step (5 steps after 2 of
     warm-up) by CUDA events, in turns, with their peak memory
 22. the last modules of the JAX package: (a) image-row sharded inference
     (dist/spatial.make_spatial_infer_step) as gloo ranks on the one card
     (`--spatial-rank`, four processes started once): dtu_default(mono=False)
     with phase 4's weights at 512x640, 5 views, batch 1 in 4 bands, then
     in 2, then at DTU's raw 1152x1600 in 2; each rank's step with every
     count at 0 just before (4 K1 launches a rank), its band's shapes, the
     stage outputs of that same step's forward (caught by a hook on the
     model) gathered and held against the single-process card forward by
     the stage comparator, each rank's peak memory and ms a step (gloo
     stages every exchange through the host: not a scaling number); then
     K1 on the last band of each run's four stages (row0 != 0, whole
     sources) against plain at atol/rtol 1e-4 and bitwise against the
     whole launch's rows.  (b) tools.test.main --vis_ETA --vis_mono on
     phase 17's scan: 28 K1 and 112 K2 launches, 35 dumps; K2 against
     plain at that path's four stage shapes (104x144 to 832x1152, batch 1,
     4 sources) at atol 1e-6; save_depth with the flags on the card
     against --device cpu at 384x512: vis_mono at rtol/atol 1e-4, vis_ETA
     within 1e-3 where the runs' hypotheses agree (at least 99% of a
     stage's pixels, all of stage 1's).  (c) the
     DTU-mid train step (batch 2, --ot_backend pallas) under no cut and
     each sg_cuts cut: zero gradients upstream, K3 only under no cut and
     "mono", the step ms by CUDA events in turns
 23. the image-row sharded train step (dist/spatial.make_spatial_train_step)
     as gloo ranks on the one card (`--spatial-train-rank`, four processes
     started once), seeded weights of dtu_default() with the mono branch
     on, one SGD step, TF32 off, the published loss weights, each run
     against one process's steps on the card: (a) the DTU-mid train cell
     (phase 8's tree, batch 2) as data 2 x spatial 2 and as spatial 2,
     each with --ot_backend pallas and xla in float32 and once in float64
     (plain warp; each split's exact reference), and as spatial 2 in
     bfloat16 compute; (b) DTU's raw 1152x1600, batch 1, as spatial 2 in
     float32 (pallas) and float64.  The float64 runs' gradients within
     relative L2 1e-7 of one process's float64 step; the float32 runs'
     scalars against one process's float32 step of the same backend (rtol
     1e-5; 1e-4 where a near-tied argmax moves a later stage's window; the
     pixel fractions atol 1e-4 more), and each gradient against one
     process's float32 step whose BatchNorm takes the ranks' arithmetic
     (flax_moments), both measured from their float64 steps: within 10x
     its noise and 1.5x the summed noise (check_grads' rule), the median
     within 2x; bf16 against one process's bf16 step (the loss at rtol
     1e-3, each stage loss at 5e-2, the gradients' median distance from
     float64 within 1.5x); the ranks' parameters, running statistics and
     scalars bitwise equal; per rank 16 K2 and 16 K3 launches, and 4 K4
     and 4 K5 with pallas; each rank's peak memory and ms, and at raw the
     peak against one process's and the prediction, the ms a step by host
     clock (gloo through the host: not a scaling number).  (c) the
     weights after (a)'s spatial-2 pallas step served through
     make_spatial_infer_step (4 K1 launches a rank), held against one
     process's forward by the stage comparator; then K2 and K3 on the
     last of two bands of the four DTU-mid stages (batch 2) and of the
     four raw stages (batch 1; row0 = half the rows, whole sources, 4
     sources) against plain (K2 bitwise, K3 at phase 7's tolerance), and
     K4/K5 at those bands' pixels (phase 12's tolerances)
 24. every variant of tests/_torch_parity.BAND_VARIANTS (reg3d, cam, dcam,
     pam, pdam, asff, convnext, convnext4, dcn) through both spatial steps
     as gloo ranks on the one card (`--spatial-variant-rank`, four
     processes started once, one process's references computed on the card
     while they run), seeded weights at dtu_default's widths, TF32 off:
     (a) serving at 512x640, 5 views, batch 1 as spatial 2, and cam, dcam,
     pdam and dcn as spatial 4 too: float32 with every count at 0 just
     before (4 K1 launches a rank, and 4 K7 with dcn), held to one process's float32 forward
     by F32_AGREE (windows and decisive depths), and float64 (K1's and
     K7's plain versions) held to one process's float64 forward by the stage
     comparator and every stage's attention within F64_ATTN_ATOL; each
     rank's peak memory against one process's; (b) the DTU-mid train cell
     (phase 8's tree, batch 2, mono on) as spatial 2, one SGD step:
     float64 (plain warp and K7's plain version, xla) within relative L2 1e-7 of one process's
     float64 step, float32 --ot_backend pallas against one process's
     float32 step with the ranks' BatchNorm arithmetic (scalars at rtol
     1e-5, VARIANT_WINDOW_RTOL downstream of a window; every gradient
     finite, their median distance from float64 within F32_NOISE_RATIO
     times one process's; the pixels whose hypothesis
     window moved from the float64 step, counted), 16 K2, 16 K3, 4 K4 and
     4 K5 launches a rank (and 4 K7 with dcn in float32), ranks bitwise equal; (c) K1 on the last of 2
     and of 4 bands, and K2-K5 on the last of 2, of the DTU-mid stages
     against plain
 25. K6 (the planar convs' weight gradient) at each of Reg2d's 7 planar
     convs at the four stages of the DTU-mid and the 576x768 train steps
     (batch 2) and on two band shapes of make_spatial_train_step (conv0
     without row padding, the transposed conv11 before its crop), on
     random inputs: the same bits from two launches, against its plain
     version grouped as the kernel groups its partial sums, and, with
     cuDNN's weight gradient (autograd's call, which the port no longer
     makes for these convs), against the plain version in float64, per
     conv: K6 within twice cuDNN's relative L2 distance; K6 and cuDNN
     timed queued, the plain version back to back, beside the bound
     (a line a conv).  Phase 8 counts 28
     K6 launches a step.  `python3 chip_smoke.py k6` runs phases 1, 2 and
     25 alone.
 26. K7 (the DCN heads' sampling and contraction) at the four heads of a
     served --dcn view (832x1152, 5 images; C = 64, 32, 16, 8 at strides
     8 to 1) with offsets of three reaches (N(0, 1) px, uniform +-4 px,
     uniform +-64 px): the same bits from two launches, against its plain
     version (atol = rtol = K7_TOL); K7 timed queued (the kernel alone
     and the wrapper's call with its channels-last copy), the plain
     version back to back, beside the bound (the map, offsets, mask and
     output bytes at 3.35 TB/s or the contraction's and sampling's FLOPs
     at 67 TFLOP/s; a line a head), and ptxas's report of its instances.
     `python3 chip_smoke.py k7` runs phases 1, 2 and 26 alone.

The last three lines are the card's name and power limit, a JSON line with
the kernels' launches, errors and times (summed over the four stages; K2
and K3 for one source view per stage, as one launch covers; every kernel
timed queued, with its back-to-back time beside; K1's launches are phase
5's, with those of phases 5, 17 and 19 under launches_by_path, and its
max_abs_err the largest of phases 3, 17 and 19, each under
max_abs_err_by_path; every kernel's launches on phase 20 (a)'s path
and over phase 21's paths under launches_by_path, with phase 22's:
spatial_serve (K1, over the ranks of its three runs; its band error
under max_abs_err_by_path), vis_eta (K2; its error beside train's under
max_abs_err_by_path) and sg_cuts (K2-K5)), and phase 23's:
spatial_train (K2-K5 over the ranks of its runs; their band errors under
max_abs_err_by_path) and spatial_train_serve (K1, (c)), and phase 24's:
spatial_variants_serve (K1) and spatial_variants_train (K2-K5), over the
ranks, their band errors under max_abs_err_by_path; K6's times are the
DTU-mid step's 28 convs, its launches phase 8's; K7's times are a served
--dcn view's four heads, its launches phase 21 (a)'s, and its launches on
phase 21 (c)'s and phase 24's paths under launches_by_path), and
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
    FUSION_EDGE,
    GRAD_NOISE,
    BAND_VARIANTS,
    VARIANTS,
    assert_bf16_close,
    assert_masks_agree,
    assert_stage_close,
    fusion_edge_pixels,
    plane_batch,
    plane_gt_points,
    relative_l2,
    stage_inputs,
    t,
    to_numpy_tree,
    torch_batch,
    write_blendedmvs_tree,
    write_dtu_gt_tree,
    write_dtu_tree,
    write_plane_scan,
    write_tanks_tree,
)
from helpers import synthetic_sample  # noqa: E402
from mvster_tpu_torch.core.geometry import plane_sweep_coords  # noqa: E402
from mvster_tpu_torch.core.sampling import bilinear_taps  # noqa: E402
from mvster_tpu_torch.dist.train_step import make_train_step  # noqa: E402
from mvster_tpu_torch.infer.ply import read_ply  # noqa: E402
from mvster_tpu_torch.kernels import (  # noqa: E402
    _build,
    conv_wgrad,
    deform_conv,
    sinkhorn_ot,
    warp_correlate,
    warp_vjp,
)
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
# phase 16: depth and group counts off dtu_default's (8, 8, 4, 4) / (8, 8, 4, 4)
OFF_DG = [(2, 2), (3, 2), (16, 16)]  # K1 at the stage-1 shape (C = 64)
OFF_D = [1, 2, 3, 5, 16, 31, 32, 33, 64]  # K4/K5: every capacity, D below it
# K4/K5's shapes: B * N no multiple of a block's pixels; a full card (one
# thread a pixel at some D <= 8); stage 1's, where they are timed
OFF_OT_SHAPES = [(31, 37), (256, 320), (64, 80)]
OFF_CONFIG = dict(stage_splits=(16, 8, 4, 4), group_cor_dim=(16, 8, 4, 2))
OFF_H, OFF_W, OFF_VIEWS = 128, 192, 3
K6 = dict(name="conv_wgrad", route="cuda", source="mvster_tpu_torch/csrc/conv_wgrad.cu",
          replaces=None)
K6_PER_STEP = 28  # Reg2d's 7 planar convs x 4 stages
K6_ENTRY = "k6"  # `python3 chip_smoke.py k6`: phases 1, 2 and 25 alone
K7 = dict(name="deform_conv", route="cuda", source="mvster_tpu_torch/csrc/deform_conv.cu",
          replaces=None)
K7_ENTRY = "k7"  # `python3 chip_smoke.py k7`: phases 1, 2 and 26 alone
K7_VIEWS = 5  # a served view's images (dtu-test-serve-dcn)
K7_TOL = 1e-5  # atol = rtol: float32 sums of 9C products in another order
# offsets: N(0, 1) px, uniform +-4 px, uniform +-64 px (most taps clamped)
K7_REACHES = [("normal1", None), ("uniform4", 4.0), ("uniform64", 64.0)]
# phases 17-19: the serving path through tools.test.main.  DTU's published
# 1200x1600 images at the CLI's default --max_h 864 --max_w 1152, which the
# loader snaps down to multiples of 64: 832x1152; 7 views of a scan's 49; a
# textured plane at 600 mm; the ground truth on a 0.35 mm grid where at
# least 5 of the 7 cameras see the plane
DTU_H, DTU_W, DTU_VIEWS = 1200, 1600, 7
SERVE_H, SERVE_W = 832, 1152
PLANE_Z, DTU_BASELINE, GT_SPACING = 600.0, 40.0, 0.35
SERVE_FLAGS = ["--group_cor", "--inverse_depth", "--attn_temp", "2"]
TANKS_H, TANKS_W, TANKS_VIEWS = 1080, 1920, 3  # 3 views of the hundreds a scan has
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


def build_model(seed, **overrides):
    model = MVS4Net(MVS4NetConfig.dtu_default(**{"mono": False, **overrides}))
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


def profile_forward(model, inputs, fwd_ms, card, n=5, label="6 times"):
    """torch.profiler over n eval forwards: device-busy ms a forward, its
    share of the CUDA-event time fwd_ms, launches, K1's share, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            model(*inputs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    busy = sum(dev_us.values()) / n / 1e3
    k1 = sum(v for k, v in dev_us.items() if "warp_correlate_kernel" in k) / n / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    log(f"[{label}] profile of {n} forwards: device busy {busy:.3f} ms a forward "
        f"({busy / fwd_ms:.1%} of the {fwd_ms:.3f} ms by CUDA events), "
        f"{sum(e.count for e in kernels) // n} kernel launches a forward; K1 {k1:.4f} ms "
        f"({k1 / busy:.1%} of busy); top kernels by device time a forward: "
        + "; ".join(f"{k[:70]} {v / n / 1e3:.4f} ms" for k, v in top) + f" | {card}")


def phase6_k1_times(stage_args, card):
    """K1 per DTU-mid stage (batch 1, four source views, attn_fuse_d), in
    turns plain, kernel, wrapper and back: the kernel on precomputed
    rot/trans queued behind a spin of the card and back to back, the
    wrapper with its plane_sweep_rts glue and the plain version back to
    back; beside the bound and the launch's blocks.  Returns the sums over
    the stages and each stage's (bound, bound_by)."""
    sums = dict(qk=0.0, k=0.0, w=0.0, p=0.0, b=0.0)
    bounds = []
    for si, (args, g) in enumerate(stage_args):
        h, w, c, d, _ = STAGES[si]
        ref_feat, src_feats, ref_proj, src_projs, hypo = args
        rot, trans = warp_correlate.plane_sweep_rts(ref_proj, src_projs)
        fns = dict(
            k=lambda: warp_correlate.launch(ref_feat, src_feats, hypo, rot, trans, g, 2.0, True),
            w=lambda: warp_correlate.fused_cost_volume(*args, g, 2.0, True),
            p=lambda: warp_correlate.fused_cost_volume_plain(*args, g, 2.0, True),
        )
        order = ["p", "k", "w"]
        times = {k: [] for k in fns}
        queued = []
        for name in order + order[::-1]:
            times[name].append(cuda_ms(fns[name], iters=20))
            if name == "k":
                queued.append(queued_ms(fns[name], iters=20))
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        ms["qk"] = sum(queued) / len(queued)
        b, by = bound(*k1_work(h, w, c, d, g))
        bounds.append((b, by))
        ms["b"] = b
        for k in sums:
            sums[k] += ms[k]
        plan = warp_correlate.plan_launch(d, c, g)
        log(f"[6 times] stage{si + 1} {(h, w)} C={c} D={d} G={g}, {NVIEWS - 1} views: K1 "
            f"queued {ms['qk']:.4f} ms, back to back {ms['k']:.4f}; with rot/trans "
            f"{ms['w']:.4f}; plain {ms['p']:.4f}; bound {b:.4f} by {by}; "
            f"{-(-h * w // plan.pixels)} blocks of {plan.threads} threads, float4 split "
            f"{plan.split} | {card}")
    log(f"[6 times] K1 over the four stages: queued {sums['qk']:.4f} ms, back to back "
        f"{sums['k']:.4f}; with rot/trans {sums['w']:.4f}; plain {sums['p']:.4f}; bound "
        f"{sums['b']:.4f} (" + ", ".join(f"s{i + 1} {b * 1e3:.1f} us by {by}"
                                        for i, (b, by) in enumerate(bounds)) + f") | {card}")
    return sums, bounds


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
    conv_wgrad.conv_wgrad.launches = 0
    t0 = time.perf_counter()
    result = train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k2, k3 = warp_vjp.warp_gather.launches, warp_vjp.scatter_grad.launches
    k6 = conv_wgrad.conv_wgrad.launches
    steps = result["steps"]
    if steps != NVIEWS * 7 // BATCH:
        raise AssertionError(f"{steps} train steps, expected {NVIEWS * 7 // BATCH}")
    per_step = 4 * (NVIEWS - 1)
    if k2 != per_step * steps or k3 != per_step * steps:
        raise AssertionError(f"K2 {k2} / K3 {k3} launches for {steps} steps, "
                             f"expected {per_step} each per step")
    if k6 != K6_PER_STEP * steps:
        raise AssertionError(f"K6 {k6} launches for {steps} steps, expected {K6_PER_STEP} a step")
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
        f"K2 {k2} and K3 {k3} launches ({per_step} per step), K6 {k6} ({K6_PER_STEP}); "
        f"{len(moved)} of "
        f"{len(params)} parameter tensors moved (the mono decoder's, weighted 0, did "
        f"not); the checkpoint loaded strictly and served a request through "
        f"{k1} K1 launches in {1e3 * served[0][1]['seconds']:.2f} ms | {card}")
    return k2, k3, k6, root, result["checkpoint"]


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
    """K4's and K5's least work for n pixels of D bins: (float32-pipe
    instructions, MUFU instructions, bytes).  It counts the algorithm's
    operations, the steps of the plain versions (sinkhorn_pixels_plain,
    sinkhorn_pixels_bwd_plain), whatever design runs them: not the shuffles,
    shared-memory transposes or guards of csrc/sinkhorn_ot.cu.  Per pixel
    each counts its expf, logf and divisions at `costs` (math_costs) and
    its adds and multiplies, a multiply-add as one FFMA and a sum of D
    terms as D - 1 adds:
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
    inv = 1.0 / 935.0 + (1.0 / 425.0 - 1.0 / 935.0) * np.arange(d) / max(d - 1, 1)
    hypo = (1.0 / inv)[None, :, None, None] * rng.uniform(0.95, 1.05, size=(b, d, h, w))
    logits = rng.normal(size=(b, d, h, w)) * 3.0
    attn = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    gt = rng.uniform(440, 920, size=(b, h, w))
    mask = torch.from_numpy(rng.uniform(size=(b, h, w)) > 0.2).to(dev)
    return t(gt, dev), t(hypo, dev), t(attn, dev), mask


def _assert_dpred_close(got, want):
    torch.testing.assert_close(got, want, rtol=K5_RTOL,
                               atol=K5_FLOOR * want.abs().max().item())


def k45_vs_plain(gt, hypo, attn, mask):
    """K4 and K5 against their plain versions on one stage's inputs (phase
    12's tolerances): (K4's and K5's largest |kernel - plain|, and the
    kernels' inputs pred, gt_idx, the mask m and the cotangent g)."""
    b, d, h, w = attn.shape
    pred = attn.reshape(b, d, h * w)
    gt_idx = torch.argmin((hypo - gt[:, None]).abs(), dim=1).reshape(b, h * w).int()
    m = mask.reshape(b, h * w).float()
    g = m / m.sum().clamp(min=1.0)
    loss = sinkhorn_ot.sinkhorn_fwd(pred, gt_idx, OT_ITERS)
    dpred = sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g, OT_ITERS)
    want = sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, OT_ITERS)
    dwant = sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred, gt_idx, g, OT_ITERS)
    torch.cuda.synchronize()
    if not (torch.isfinite(loss).all() and torch.isfinite(dpred).all()):
        raise AssertionError(f"{h}x{w}, D {d}: non-finite K4/K5 output")
    torch.testing.assert_close(loss, want, rtol=K4_RTOL, atol=K4_ATOL)
    _assert_dpred_close(dpred, dwant)
    return ((loss - want).abs().max().item(), (dpred - dwant).abs().max().item(),
            pred, gt_idx, m, g)


def phase12_sinkhorn(dev):
    """K4 and K5 against their plain versions at the DTU-mid stage shapes,
    batch 2; returns the max errors and each stage's inputs for phase 15."""
    err4 = err5 = errf = 0.0
    per_stage = []
    for si, (h, w, _, d, _) in enumerate(STAGES):
        gt, hypo, attn, mask = ot_inputs(400 + si, h, w, d, dev)
        e4, e5, pred, gt_idx, m, g = k45_vs_plain(gt, hypo, attn, mask)
        err4, err5 = max(err4, e4), max(err5, e5)
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
               warp_vjp.scatter_grad, warp_correlate.fused_cost_volume, deform_conv.deform_conv):
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
    through warp_plain) and the DCN heads take K7's plain version, which
    take any dtype: the float64 reference step."""
    kernel, k7 = warp_vjp.grid_sample_zeros_vjp, deform_conv.deform_conv
    warp_vjp.grid_sample_zeros_vjp = warp_vjp.warp_plain
    deform_conv.deform_conv = deform_conv.deform_conv_plain
    try:
        yield
    finally:
        warp_vjp.grid_sample_zeros_vjp, deform_conv.deform_conv = kernel, k7


@contextlib.contextmanager
def plain_eval():
    """Within: the eval cost volume takes K1's plain version and the DCN
    heads K7's, which take any dtype: the float64 reference forward."""
    k1, k7 = warp_correlate.fused_cost_volume, deform_conv.deform_conv
    warp_correlate.fused_cost_volume = warp_correlate.fused_cost_volume_plain
    deform_conv.deform_conv = deform_conv.deform_conv_plain
    try:
        yield
    finally:
        warp_correlate.fused_cost_volume, deform_conv.deform_conv = k1, k7


def dtu_batch(root, dev):
    """The first batch of the DTU tree's training loader, on the device."""
    from mvster_tpu_torch.data import MVSLoader
    from mvster_tpu_torch.data.dtu import DTUDataset
    from mvster_tpu_torch.train.loop import device_batch

    ds = DTUDataset(root, f"{root}/train.txt", "train", NVIEWS, 1.06, seed=1)
    return device_batch(next(iter(MVSLoader(ds, BATCH, prefetch=0))), dev)


def backend_step(config, sd, batch, backend, dtype=torch.float32):
    """One train step (SGD at lr 0) of `config` from the state dict sd on
    batch, with the OT loss through `backend`: its scalars and the model,
    whose parameters hold the gradients."""
    model = MVS4Net(config)
    model.load_state_dict(sd, strict=True)
    model.to(device=batch["imgs"].device, dtype=dtype)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                           loss_kwargs=dict(LOSS_KW, ot_backend=backend))
    scalars, _ = step(batch)
    return scalars, model


def ot_losses(scalars):
    return [float(scalars[f"s{i}_c_loss"]) for i in range(4)]


def phase14_backends(dev, root):
    """ot_backend pallas against xla on one DTU-mid train step."""
    config = MVS4NetConfig.dtu_default()
    sd = init_state_dict(MVS4Net(config), seed=1)
    batch = dtu_batch(root, dev)
    runs = {}
    for name, backend, dtype in (("pallas", "pallas", torch.float32),
                                 ("xla", "xla", torch.float32),
                                 ("exact", "xla", torch.float64)):
        if dtype == torch.float64:
            b = {k: ({s: x.double() for s, x in v.items()} if isinstance(v, dict)
                     else v.double()) for k, v in batch.items()}
            with plain_warp():
                scalars, model = backend_step(config, sd, b, backend, dtype)
        else:
            scalars, model = backend_step(config, sd, batch, backend, dtype)
        runs[name] = dict(ot=ot_losses(scalars),
                          grads={k: p.grad.double().cpu().numpy()
                                 for k, p in model.named_parameters()})
        del model
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

    sums = dict(k4=0.0, k5=0.0, p4=0.0, p5=0.0, xla=0.0, fused=0.0, b4=0.0, b5=0.0,
                qk4=0.0, qk5=0.0)
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
        queued = {k: [] for k in ("k4", "k5")}
        for name in order + order[::-1]:
            times[name].append(cuda_ms(fns[name], iters=10))
            if name in queued:
                queued[name].append(queued_ms(fns[name], iters=20))
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        ms.update({"q" + k: sum(v) / len(v) for k, v in queued.items()})
        (f4, s4, n4), (f5, s5, n5) = ot_work(BATCH * h * w, d, costs)
        b4, by4 = ot_bound(f4, s4, n4, rates)
        b5, by5 = ot_bound(f5, s5, n5, rates)
        for k in ms:
            sums[k] += ms[k]
        sums["b4"] += b4
        sums["b5"] += b5
        p4, p5 = (sinkhorn_ot.plan_launch(k, d, OT_ITERS, BATCH * h * w) for k in ("fwd", "bwd"))
        log(f"[15 times] stage{si + 1} {(h, w)} D={d} B={BATCH}, K4 {p4.design} x {p4.threads}, "
            f"K5 {p5.design} x {p5.threads} ({p5.smem} B): K4 "
            f"{ms['qk4']:.4f} ms queued ({ms['k4']:.4f} back to back), bound {b4:.4f} by {by4} "
            f"({f4:.4e} float32-pipe and {s4:.4e} MUFU instructions), {100 * b4 / ms['qk4']:.1f}% "
            f"of the bound, plain {ms['p4']:.4f}; K5 {ms['qk5']:.4f} ms queued "
            f"({ms['k5']:.4f}), bound {b5:.4f} ({f5:.4e} float32-pipe, {s5:.4e} MUFU), "
            f"{100 * b5 / ms['qk5']:.1f}% of the bound, plain {ms['p5']:.4f}; loss "
            f"forward+backward: pallas (K4+K5) {ms['fused']:.4f} ms, xla (checkpointed plain) "
            f"{ms['xla']:.4f} ms | {card}")
    log(f"[15 times] over the four stages, queued (back to back): K4 {sums['qk4']:.4f} "
        f"({sums['k4']:.4f}) ms, bound {sums['b4']:.4f}, {100 * sums['b4'] / sums['qk4']:.1f}% "
        f"of it, plain {sums['p4']:.4f}; K5 {sums['qk5']:.4f} ({sums['k5']:.4f}) ms, bound "
        f"{sums['b5']:.4f}, {100 * sums['b5'] / sums['qk5']:.1f}% of it, plain {sums['p5']:.4f}; "
        f"loss forward+backward pallas {sums['fused']:.4f} ms vs xla {sums['xla']:.4f} ms "
        f"| {card}")

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


def phase16_off_default(dev, card, rates, costs):
    """Depth and group counts off dtu_default: K1, K4 and K5 against their
    plain versions (K4/K5 also at a ragged shape, and timed against their
    bound), and one eval forward and one train step per OT backend of a
    model whose stages take them (OFF_CONFIG)."""
    h, w, c = STAGES[0][:3]
    err1 = 0.0
    for i, (d, g) in enumerate(OFF_DG):
        inp = stage_inputs(500 + i, h, w, c, d, nsrc=NVIEWS - 1)
        args = [t(inp[k], dev) for k in ("ref", "src", "ref_proj", "src_projs", "hypo")]
        for fuse in (True, False):
            before = warp_correlate.fused_cost_volume.launches
            got = warp_correlate.fused_cost_volume(*args, g, 2.0, fuse)
            want = warp_correlate.fused_cost_volume_plain(*args, g, 2.0, fuse)
            torch.cuda.synchronize()
            if warp_correlate.fused_cost_volume.launches != before + 1:
                raise AssertionError(f"D={d} G={g}: no K1 launch")
            if not torch.isfinite(got).all():
                raise AssertionError(f"D={d} G={g}: non-finite K1 output")
            torch.testing.assert_close(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
            err1 = max(err1, (got - want).abs().max().item())
    err4 = err5 = 0.0
    timed = []
    for i, d in enumerate(OFF_D):
        for oh, ow in OFF_OT_SHAPES:
            if oh * ow > 64 * 80 and d > 8:
                continue  # the plain version's (B, D, D, N) grows with D^2
            gt, hypo, attn, mask = ot_inputs(600 + i, oh, ow, d, dev)
            pred = attn.reshape(BATCH, d, oh * ow)
            gt_idx = torch.argmin((hypo - gt[:, None]).abs(), dim=1).reshape(BATCH, oh * ow).int()
            m = mask.reshape(BATCH, oh * ow).float()
            g = m / m.sum().clamp(min=1.0)
            loss = sinkhorn_ot.sinkhorn_fwd(pred, gt_idx, OT_ITERS)
            dpred = sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g, OT_ITERS)
            want = sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, OT_ITERS)
            dwant = sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred, gt_idx, g, OT_ITERS)
            torch.cuda.synchronize()
            if not (torch.isfinite(loss).all() and torch.isfinite(dpred).all()):
                raise AssertionError(f"D={d} at {oh}x{ow}: non-finite K4/K5 output")
            torch.testing.assert_close(loss, want, rtol=K4_RTOL, atol=K4_ATOL)
            _assert_dpred_close(dpred, dwant)
            err4 = max(err4, (loss - want).abs().max().item())
            err5 = max(err5, (dpred - dwant).abs().max().item())
        # timed at the last shape (64x80, as stage 1), queued
        q4 = queued_ms(lambda: sinkhorn_ot.sinkhorn_fwd(pred, gt_idx, OT_ITERS), iters=20)
        q5 = queued_ms(lambda: sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g, OT_ITERS), iters=20)
        (f4, s4, n4), (f5, s5, n5) = ot_work(BATCH * oh * ow, d, costs)
        b4, b5 = ot_bound(f4, s4, n4, rates)[0], ot_bound(f5, s5, n5, rates)[0]
        timed.append(f"D={d} {sinkhorn_ot.plan_launch('fwd', d, OT_ITERS, BATCH * oh * ow).design} "
                     f"K4 {q4:.4f} "
                     f"({100 * b4 / q4:.1f}% of {b4:.4f}) K5 {q5:.4f} ({100 * b5 / q5:.1f}% of "
                     f"{b5:.4f})")
    log(f"[16 off-default] K1 vs plain at {h}x{w}, C={c}, (D, G) in {OFF_DG}, both attention "
        f"modes: max|d| {err1:.3e} (atol=rtol={KERNEL_TOL}); K4/K5 vs plain at "
        f"{OFF_OT_SHAPES}, batch {BATCH}, D in {OFF_D}: max|d| {err4:.3e} and {err5:.3e}")
    log(f"[16 off-default] K4/K5 ms queued at {OFF_OT_SHAPES[-1][0]}x{OFF_OT_SHAPES[-1][1]}, "
        f"batch {BATCH}, {OT_ITERS} iterations, against the bound: " + "; ".join(timed)
        + f" | {card}")

    sample = synthetic_sample(16, nviews=OFF_VIEWS, h=OFF_H, w=OFF_W)
    model_cpu = build_model(seed=16, **OFF_CONFIG)
    model = copy.deepcopy(model_cpu).to(dev)
    with torch.inference_mode():
        warp_correlate.fused_cost_volume.launches = 0
        out = model(*model_inputs(sample, dev))
        torch.cuda.synchronize()
        k1 = warp_correlate.fused_cost_volume.launches
        ref = model_cpu(*model_inputs(sample, "cpu"))
    out, ref = to_numpy_tree(out), to_numpy_tree(ref)
    planes = [out[f"stage{s}"]["attn_weight"].shape[1] for s in range(1, 5)]
    if k1 != 4 or planes != list(OFF_CONFIG["stage_splits"]):
        raise AssertionError(f"off-default forward: {k1} K1 launches, planes {planes}")
    if not np.isfinite(out["depth"]).all():
        raise AssertionError("off-default forward: non-finite depth")
    assert_stage_close(ref, out)
    del model, model_cpu

    config = MVS4NetConfig.dtu_default(**OFF_CONFIG)
    sd = init_state_dict(MVS4Net(config), seed=16)
    batch = torch_batch(plane_batch(1, h=OFF_H, w=OFF_W), dev)
    ot, launches = {}, {}
    for backend in ("pallas", "xla"):
        _reset_counts()
        scalars, model = backend_step(config, sd, batch, backend)
        torch.cuda.synchronize()
        launches[backend] = (sinkhorn_ot.sinkhorn_fwd.launches, sinkhorn_ot.sinkhorn_bwd.launches)
        ot[backend] = ot_losses(scalars)
        del model
    if launches != {"pallas": (4, 4), "xla": (0, 0)}:
        raise AssertionError(f"off-default train step: K4/K5 launches {launches}")
    np.testing.assert_allclose(ot["pallas"], ot["xla"], rtol=1e-5)
    torch.cuda.empty_cache()
    log(f"[16 off-default] eval forward at {OFF_H}x{OFF_W}, {OFF_VIEWS} views, stage_splits "
        f"{OFF_CONFIG['stage_splits']}, group_cor_dim {OFF_CONFIG['group_cor_dim']}: {k1} K1 "
        f"launches, matches the CPU plain path by the stage comparator; a train step with "
        f"ot_backend pallas ({launches['pallas'][0]} K4, {launches['pallas'][1]} K5 launches) "
        f"against xla: per-stage OT loss " + ", ".join(f"{x:.6f}" for x in ot["pallas"])
        + " vs " + ", ".join(f"{x:.6f}" for x in ot["xla"]) + f" (rtol 1e-5) | {card}")


def _serve(argv, card, what):
    """tools.test.main over argv with every kernel count at 0 just before;
    returns (main's wall times, K1 launches, seconds in all)."""
    from mvster_tpu_torch.tools import test as test_tool

    _reset_counts()
    t0 = time.perf_counter()
    times = test_tool.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    k1 = warp_correlate.fused_cost_volume.launches
    others = [fn.launches for fn in (warp_vjp.warp_gather, warp_vjp.scatter_grad,
                                     sinkhorn_ot.sinkhorn_fwd, sinkhorn_ot.sinkhorn_bwd)]
    if any(others):
        raise AssertionError(f"{what}: training kernels launched while serving: {others}")
    return times, k1, total_s


def k1_on_cascade(dev, h, w, nsrc, seed):
    """K1 against its plain version at the four stage shapes that an h x w
    forward with nsrc source views gives it (dtu_default's C, D and G a
    stage, as STAGES), both attention modes, at atol/rtol KERNEL_TOL;
    returns the largest |kernel - plain|.  Called after the path's counts
    were read, so these launches count on no path."""
    err = 0.0
    for si, (_, _, c, d, g) in enumerate(STAGES):
        inp = stage_inputs(seed + si, h >> (3 - si), w >> (3 - si), c, d, nsrc=nsrc)
        args = [t(inp[k], dev) for k in ("ref", "src", "ref_proj", "src_projs", "hypo")]
        for fuse in (True, False):
            got = warp_correlate.fused_cost_volume(*args, g, 2.0, fuse)
            want = warp_correlate.fused_cost_volume_plain(*args, g, 2.0, fuse)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{h}x{w} stage{si + 1}: non-finite K1 output")
            torch.testing.assert_close(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
            err = max(err, (got - want).abs().max().item())
        del args, got, want
    torch.cuda.empty_cache()
    return err


def k2_on_cascade(dev, h, w, nsrc, seed):
    """K2 against its plain version at the four stage shapes that an h x w
    forward with nsrc source views gives it (batch 1, dtu_default's C and
    D a stage, as STAGES), each source view's coordinates from
    plane_sweep_coords, at atol K2_ATOL; returns the largest
    |kernel - plain|.  Called after the path's counts were read, so these
    launches count on no path."""
    err = 0.0
    for si, (_, _, c, d, _) in enumerate(STAGES):
        hs, ws = h >> (3 - si), w >> (3 - si)
        inp = stage_inputs(seed + si, hs, ws, c, d, nsrc=nsrc)
        ref_proj, hypo = t(inp["ref_proj"], dev), t(inp["hypo"], dev)
        for v in range(nsrc):
            x, y = plane_sweep_coords(t(inp["src_projs"][v], dev), ref_proj, hypo)
            src = t(inp["src"][v], dev)
            got = warp_vjp.warp_gather(src, x, y)
            want = warp_vjp.warp_plain(src, x, y)
            torch.cuda.synchronize()
            if got.shape != (1, d, hs, ws, c) or not torch.isfinite(got).all():
                raise AssertionError(f"{h}x{w} stage{si + 1} view {v}: K2 {tuple(got.shape)}")
            torch.testing.assert_close(got, want, rtol=0, atol=K2_ATOL)
            err = max(err, (got - want).abs().max().item())
            del x, y, src, got, want
    torch.cuda.empty_cache()
    return err


def _sequential_views(model, samples, eval_batch=1, return_debug=False):
    """infer_views' views from one model(...) call per chunk, each waited on
    before the next is launched: the reference of phase 17's dispatch-ahead."""
    device = next(model.parameters()).device
    samples = list(samples)
    for start in range(0, len(samples), eval_batch):
        chunk = samples[start:start + eval_batch]
        padded = chunk + [chunk[-1]] * (eval_batch - len(chunk))
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(*model_inputs({
                "imgs": np.stack([s["imgs"] for s in padded]),
                "proj_matrices": {k: np.stack([s["proj_matrices"][k] for s in padded])
                                  for k in padded[0]["proj_matrices"]},
                "depth_values": np.stack([s["depth_values"] for s in padded])}, device))
            depth = out["depth"].cpu().numpy()
            conf = out["photometric_confidence"].cpu().numpy()
        seconds = time.perf_counter() - t0
        for i, sample in enumerate(chunk):
            yield sample, {"depth": depth[i:i + 1], "confidence": conf[i:i + 1],
                           "seconds": seconds, "chunk_views": len(chunk)}


def _busy_share(prof, wall_s):
    """The share of wall_s in which the card ran a kernel or a copy: the union
    of the profile's device intervals over the wall time."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        raise AssertionError("the profile holds no device activity")
    return busy / 1e6 / wall_s


def phase17_dispatch_ahead(dev, tmp, argv, scan, card):
    """tools.test.save_depth over phase 17's scan, its infer_views (the next
    chunk launched before the current one's views are written) against the
    same loop with one model(...) call per chunk in sequence: the loop's
    wall time of each, in turns; the card's busy share over each loop under
    torch.profiler; and, with cuDNN's deterministic algorithms, each view's
    depth and confidence bitwise equal.  Under cuDNN's default algorithms
    the eval forward is not bitwise reproducible from call to call on the
    card (measured on an H100: attention up to 3.8e-6 apart, a near-tied
    depth flipped; the FPN's features reproducible, so Reg2d's 3D and
    transposed convs), whatever the loop."""
    from torch.profiler import ProfilerActivity, profile

    from mvster_tpu_torch.tools import test as test_tool
    from mvster_tpu_torch.tools.cli import build_test_parser, model_config_from_args

    args = build_test_parser().parse_args(argv)
    config = model_config_from_args(args)
    model = MVS4Net(config)
    model.load_state_dict(load_reference_ckpt(args.loadckpt, config), strict=True)
    model.to(dev).eval()
    loops = {"ahead": test_tool.infer_views, "sequential": _sequential_views}
    views, walls, busy = {}, {k: [] for k in loops}, {}

    def run(kind, i, profiled=False, timed=False):
        got = []

        def capture(*a, **k):
            for sample, res in loops[kind](*a, **k):
                got.append((res["depth"].copy(), res["confidence"].copy()))
                yield sample, res

        args.outdir = os.path.join(tmp, f"dtu_loop_{kind}_{i}")
        test_tool.infer_views = capture
        try:
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                  if profiled else contextlib.nullcontext()) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                test_tool.save_depth(args, model, [scan])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            test_tool.infer_views = loops["ahead"]
        views[(kind, i)] = got
        if profiled:
            busy[kind] = _busy_share(prof, wall)
        if timed:
            walls[kind].append(wall)

    for i, kind in enumerate(("sequential", "ahead", "ahead", "sequential")):
        run(kind, i, timed=True)
    for kind in loops:
        run(kind, "profiled", profiled=True)
    views.clear()
    torch.backends.cudnn.deterministic = True
    try:
        for kind in loops:
            run(kind, "deterministic")
    finally:
        torch.backends.cudnn.deterministic = False

    def max_diff(a, b):
        return max(float(np.abs(x - y).max()) for va, vb in zip(a, b) for x, y in zip(va, vb))

    if any(len(got) != DTU_VIEWS for got in views.values()):
        raise AssertionError(f"views {[len(got) for got in views.values()]}")
    first = views[("sequential", "deterministic")]
    diffs = {f"{kind} {i}": max_diff(got, first) for (kind, i), got in views.items()}
    if any(diffs.values()):
        raise AssertionError(f"depth or confidence max|d| from the first sequential loop's, "
                             f"by loop (cuDNN deterministic): {diffs}")
    del model
    torch.cuda.empty_cache()
    log(f"[17 dispatch-ahead] save_depth over the scan ({DTU_VIEWS} views at "
        f"{SERVE_H}x{SERVE_W}, eval_batch {args.eval_batch}): with cuDNN's deterministic "
        f"algorithms every view's depth and confidence bitwise those of one model(...) "
        f"call per chunk in sequence; wall s "
        f"(host clock, in turns sequential, ahead, ahead, sequential): dispatch-ahead "
        + " / ".join(f"{w:.3f}" for w in walls["ahead"]) + ", sequential "
        + " / ".join(f"{w:.3f}" for w in walls["sequential"])
        + f"; the card's busy share of the loop (torch.profiler, the union of its kernels "
        f"and copies over the wall time, a further run of each): dispatch-ahead "
        f"{busy['ahead']:.2%}, sequential {busy['sequential']:.2%} | {card}")
    return walls, busy


def phase17_dtu_scan(dev, tmp, ckpt, card):
    """The DTU serving path end to end through tools.test.main: a synthetic
    7-view scan at DTU's 1200x1600, read at 832x1152, filtered and
    fused on the card, scored by the DTU metric against a synthetic
    SampleSet tree of the plane; then K1 against its plain version at the
    four stage shapes of that forward (104x144 to 832x1152, 4 sources).

    The metric is expected to read NaN here: phase 8's checkpoint, one
    epoch on random-texture scenes, predicts no depth on the plane, and of
    the ~100 points the filter keeps none lies within the metric's 20 mm
    outlier cut.  So this phase checks that main writes dtu_metrics.json
    with its keys, and phase 18 carries the scored check: evaluate_dtu,
    the function main calls, on the card's cloud of the plane's analytic
    depth maps must read finite numbers and an accuracy under 0.2 mm."""
    from mvster_tpu_torch.data.pfm import read_pfm

    root, gt_dir = os.path.join(tmp, "dtu_test"), os.path.join(tmp, "SampleSet", "MVS Data")
    outdir = os.path.join(tmp, "dtu_out")
    t0 = time.perf_counter()
    scan, k, extrs = write_plane_scan(root, "scan1", n_views=DTU_VIEWS, h=DTU_H, w=DTU_W,
                                      z=PLANE_Z, baseline=DTU_BASELINE)
    # the plane where the filter can keep points: in the reference view and
    # at least thres_view = 4 sources
    stl = plane_gt_points(k, extrs, DTU_H, DTU_W, PLANE_Z, GT_SPACING, min_views=5)
    write_dtu_gt_tree(gt_dir, 1, stl)
    tree_s = time.perf_counter() - t0
    argv = ["--testpath", root, "--testlist", scan, "--loadckpt", ckpt, "--outdir", outdir,
            *SERVE_FLAGS, "--num_view", "5", "--thres_view", "4", "--conf", "0.5",
            "--dtu_gt_dir", gt_dir]
    times, k1, total_s = _serve(argv, card, "phase 17")
    if k1 != 4 * DTU_VIEWS or times["views"] != DTU_VIEWS:
        raise AssertionError(f"{times['views']} views, {k1} K1 launches, expected "
                             f"{DTU_VIEWS} and {4 * DTU_VIEWS}")
    for v in range(DTU_VIEWS):
        for kind in ("depth_est", "confidence"):
            m = read_pfm(os.path.join(outdir, scan, kind, f"{v:08d}.pfm"))[0]
            if m.shape != (SERVE_H, SERVE_W) or not np.isfinite(m).all():
                raise AssertionError(f"{kind} {v}: shape {m.shape}, finite {np.isfinite(m).all()}")
        for kind in ("photo", "geo", "final"):
            if not os.path.exists(os.path.join(outdir, scan, "mask", f"{v:08d}_{kind}.png")):
                raise AssertionError(f"no {kind} mask for view {v}")
    fused, _ = read_ply(os.path.join(outdir, "mvsnet001_l3.ply"))
    if not np.isfinite(fused).all():
        raise AssertionError("non-finite fused points")
    with open(os.path.join(outdir, "dtu_metrics.json")) as f:
        metrics = json.load(f)
    if not {"accuracy", "completeness", "overall"} <= metrics.keys():
        raise AssertionError(f"dtu_metrics.json keys {sorted(metrics)}")
    err = k1_on_cascade(dev, SERVE_H, SERVE_W, nsrc=4, seed=170)
    log(f"[17 dtu scan] tools.test.main on a {DTU_VIEWS}-view {DTU_H}x{DTU_W} scan at "
        f"{SERVE_H}x{SERVE_W}, 5 views a forward, thres_view 4, conf 0.5: {k1} K1 launches, "
        f"{len(fused)} fused points, accuracy {metrics['accuracy']:.4f} completeness "
        f"{metrics['completeness']:.4f} overall {metrics['overall']:.4f} mm; seconds a scan: "
        f"forward {times['forward']:.3f} (writing the views {times['depth']:.3f} in all), "
        f"fusion {times['fusion'][scan]:.3f}, metric {times['metric']:.3f}; {total_s:.1f} s "
        f"in main (trees written in {tree_s:.1f} s; GT {len(stl)} points at {GT_SPACING} mm); "
        f"K1 vs plain at this forward's stages ({SERVE_H // 8}x{SERVE_W // 8} to "
        f"{SERVE_H}x{SERVE_W}, 4 sources), both attention modes: max|d| {err:.3e} "
        f"(atol=rtol={KERNEL_TOL}) | {card}")
    phase17_dispatch_ahead(dev, tmp, argv, scan, card)
    return k1, err, dict(root=root, outdir=outdir, gt_dir=gt_dir, scan=scan, times=times)


def _scan_inputs(serve, case):
    """phase 17's scan as fuse_scene takes it: its pairs, cams as tools.test
    wrote them, and (case) the plane's analytic depth at confidence 1 or the
    predicted depth and confidence maps."""
    from mvster_tpu_torch.data.common import read_cam_file, read_pair_file
    from mvster_tpu_torch.data.pfm import read_pfm

    scan_dir = os.path.join(serve["outdir"], serve["scan"])
    pairs = read_pair_file(os.path.join(serve["root"], serve["scan"], "pair.txt"))
    intr, extr, depth, conf = {}, {}, {}, {}
    for v in range(DTU_VIEWS):
        cam = read_cam_file(os.path.join(scan_dir, f"cams/{v:08d}_cam.txt"))
        intr[v], extr[v] = cam.intrinsics, cam.extrinsics
        if case == "plane":
            depth[v] = np.full((SERVE_H, SERVE_W), PLANE_Z, np.float32)
            conf[v] = np.ones((SERVE_H, SERVE_W), np.float32)
        else:
            depth[v] = read_pfm(os.path.join(scan_dir, f"depth_est/{v:08d}.pfm"))[0]
            conf[v] = read_pfm(os.path.join(scan_dir, f"confidence/{v:08d}.pfm"))[0]
    return pairs, depth, conf, intr, extr


def phase18_fusion(dev, tmp, serve, card):
    """Fusion on the card against the CPU on phase 17's scan: (a) the plane's
    analytic depth maps, (b) the predicted ones.  geometric_filter runs once
    a reference view on each device; each device's cloud is the
    unprojection of its final mask and depth_avg, which is what fuse_scene
    does with them, and fuse_scene on the card must give the card's cloud
    bit for bit.  The card's cloud is scored by evaluate_dtu, the function
    tools.test.main runs for --dtu_gt_dir."""
    from mvster_tpu_torch.eval.dtu_metric import evaluate_dtu
    from mvster_tpu_torch.infer.fusion import fuse_scene, geometric_filter, unproject_to_world
    from mvster_tpu_torch.infer.ply import write_ply

    def score(xyz, name):
        ply_dir = os.path.join(tmp, f"fused_{name}")
        os.makedirs(ply_dir, exist_ok=True)
        write_ply(os.path.join(ply_dir, "mvsnet001_l3.ply"), xyz)
        t0 = time.perf_counter()
        summary = evaluate_dtu(ply_dir, serve["gt_dir"], [1])
        return summary, time.perf_counter() - t0

    results = {}
    for case in ("plane", "predicted"):
        pairs, depth, conf, intr, extr = _scan_inputs(serve, case)
        edges = differ = 0
        filter_ms = []
        clouds = {"card": [], "cpu": []}
        for ref, srcs in pairs:
            stack = [np.stack([a[v] for v in srcs]) for a in (depth, intr, extr)]
            edge = fusion_edge_pixels(depth[ref], intr[ref], extr[ref], *stack)
            outs = {}
            for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
                args = [t(x, d) for x in (depth[ref], conf[ref], intr[ref], extr[ref], *stack)]
                outs[name] = [x.cpu().numpy() for x in geometric_filter(*args, 0.5, 4)]
                clouds[name].append(unproject_to_world(outs[name][1], outs[name][0],
                                                       intr[ref], extr[ref])[0])
                if name == "card":
                    filter_ms.append(cuda_ms(lambda: geometric_filter(*args, 0.5, 4), iters=5))
            got, want = outs["card"], outs["cpu"]
            for i, kind in ((0, "final"), (2, "geo"), (3, "photo")):
                differ += assert_masks_agree(got[i], want[i], edge, f"{case} view {ref} {kind}")
            same = (got[2] == want[2]) & ~edge
            torch.testing.assert_close(torch.from_numpy(got[1][same]),
                                       torch.from_numpy(want[1][same]), rtol=1e-5, atol=0,
                                       equal_nan=True)
            edges += int(edge.sum())
        clouds = {name: np.concatenate(c) for name, c in clouds.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = fuse_scene(pairs, depth, conf, intr, extr, conf_thresh=0.5, thres_view=4,
                           device=dev)[0]
        fuse_s = time.perf_counter() - t0
        if not np.array_equal(fused, clouds["card"]):
            raise AssertionError(f"{case}: fuse_scene on the card differs from the card's "
                                 f"filter outputs ({len(fused)} vs {len(clouds['card'])} points)")
        same_cloud = np.array_equal(clouds["card"], clouds["cpu"])
        stats, metric_s = {}, {}
        # the metric is a function of the cloud (seeded thinning): an equal
        # cloud scores the same, so only a different one is scored again
        for name in ("card",) if same_cloud else ("card", "cpu"):
            stats[name], metric_s[name] = score(clouds[name], f"{case}_{name}")
        stats.setdefault("cpu", stats["card"])
        overall = {k: v["overall"] for k, v in stats.items()}
        # one cloud, one score: 0 even where the score is NaN (no point of a
        # cloud within the 20 mm outlier cut)
        d_overall = 0.0 if same_cloud else abs(overall["card"] - overall["cpu"])
        line = (f"[18 fusion {case}] card vs CPU over {len(pairs)} reference views "
                f"({len(pairs[0][1])} sources, {SERVE_H}x{SERVE_W}): masks agree but at "
                f"{differ} of {edges} edge pixels (within {FUSION_EDGE} of a threshold), "
                f"depth_avg within rtol 1e-5 elsewhere; {len(clouds['card'])} points on the "
                f"card, {len(clouds['cpu'])} on the CPU"
                f"{' (bitwise equal)' if same_cloud else ''}, fuse_scene on the card the same "
                f"in {fuse_s:.3f} s; overall {overall['card']:.6f} vs "
                f"{overall['cpu']:.6f} mm, |dOverall| {d_overall:.3e}; geometric_filter "
                f"{np.mean(filter_ms):.3f} ms a reference view on the card (CUDA events, "
                f"{min(filter_ms):.3f}-{max(filter_ms):.3f}); evaluate_dtu "
                f"{metric_s['card']:.2f} s on the host")
        if case == "plane":
            z = clouds["card"][:, 2]
            rel = np.abs(z - PLANE_Z).max() / PLANE_Z
            acc, comp = stats["card"]["accuracy"], stats["card"]["completeness"]
            if len(z) < DTU_VIEWS * SERVE_H * SERVE_W // 4 or rel >= 1e-3:
                raise AssertionError(f"plane: {len(z)} points, max |z - z0| / z0 {rel:.3e}")
            if not (np.isfinite([acc, comp, overall["card"]]).all() and acc < 0.2):
                raise AssertionError(f"plane: evaluate_dtu {stats['card']}")
            if not d_overall <= 1e-3:
                raise AssertionError(f"plane: |dOverall| {d_overall}")
            line += (f"; max |z - z0| / z0 {rel:.3e}, accuracy {acc:.4f} completeness "
                     f"{comp:.4f} mm")
        log(line + f" | {card}")
        results[case] = dict(edges=edges, differ=differ, d_overall=d_overall,
                             filter_ms=float(np.mean(filter_ms)), metric_s=metric_s["card"])
    return results


def phase19_tanks(dev, tmp, ckpt, card):
    """Tanks and Temples through tools.test.main: the 8 intermediate scans,
    3 views each at the published 1920x1080; then K1 against its plain
    version at the four stage shapes of that forward (128x240 to
    1024x1920, 2 sources)."""
    root, outdir = os.path.join(tmp, "tanks"), os.path.join(tmp, "tanks_out")
    t0 = time.perf_counter()
    scans = write_tanks_tree(root, "intermediate", n_views=TANKS_VIEWS, h=TANKS_H, w=TANKS_W)
    tree_s = time.perf_counter() - t0
    argv = ["--dataset", "tanks", "--split", "intermediate", "--testpath", root,
            "--testlist", "all", "--loadckpt", ckpt, "--outdir", outdir, *SERVE_FLAGS,
            "--num_view", str(TANKS_VIEWS), "--thres_view", "1"]
    times, k1, total_s = _serve(argv, card, "phase 19")
    views = TANKS_VIEWS * len(scans)
    if k1 != 4 * views or times["views"] != views or list(times["fusion"]) != scans:
        raise AssertionError(f"{times['views']} views, {k1} K1 launches, fused "
                             f"{list(times['fusion'])}")
    points = []
    for scan in scans:
        xyz, _ = read_ply(os.path.join(outdir, f"{scan}.ply"))
        if not np.isfinite(xyz).all():
            raise AssertionError(f"{scan}: non-finite points")
        points.append(len(xyz))
    h = TANKS_H - 56  # the loader's 1080 -> 1024 crop
    err = k1_on_cascade(dev, h, TANKS_W, nsrc=TANKS_VIEWS - 1, seed=190)
    fusion_s = list(times["fusion"].values())
    log(f"[19 tanks] tools.test.main --dataset tanks --split intermediate: {len(scans)} "
        f"scans x {TANKS_VIEWS} views at {TANKS_W}x{TANKS_H} (read at {TANKS_W}x"
        f"{h}), {k1} K1 launches, "
        f"{len(scans)} fused PLYs of {min(points)}-{max(points)} points; forward "
        f"{times['forward']:.3f} s for {views} views, fusion {sum(fusion_s):.3f} s "
        f"({min(fusion_s):.3f}-{max(fusion_s):.3f} a scan); {total_s:.1f} s in main (tree "
        f"written in {tree_s:.1f} s); K1 vs plain at this forward's stages ({h // 8}x"
        f"{TANKS_W // 8} to {h}x{TANKS_W}, {TANKS_VIEWS - 1} sources), both attention modes: "
        f"max|d| {err:.3e} (atol=rtol={KERNEL_TOL}) | {card}")
    return k1, err


# phase 20: data parallel.  (a) the entry point under torchrun; (b) two
# gloo ranks on the one card (NCCL puts no two ranks on one device) at the
# published per-GPU batch of 2, against one process's batch of 4
DDP_ENTRY, GLOO_RANK = "--ddp-entry", "--gloo-rank"
DDP_WORLD, DDP_LR = 2, 1e-3
# the scalars that count pixels: they may differ by a hundredth of a
# percent of the pixels (a few hundred thousand a stage at DTU-mid)
PIXEL_FRACTIONS, PIXEL_ATOL = ("thres", "s0_range", "s1_range", "s2_range", "s3_range"), 1e-4


def _launch_counts():
    return {name: fn.launches for name, fn in (
        ("K1", warp_correlate.fused_cost_volume), ("K2", warp_vjp.warp_gather),
        ("K3", warp_vjp.scatter_grad), ("K4", sinkhorn_ot.sinkhorn_fwd),
        ("K5", sinkhorn_ot.sinkhorn_bwd))}


def ddp_entry(out, argv):
    """Phase 20 (a), in the process that torchrun starts: join its group,
    run tools.train.main(argv) in it with every kernel count at 0 just
    before, then time the step wrapped in DDP against the same step
    unwrapped, in turns (CUDA events); the results go to `out` (JSON)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed, rank_device
    from mvster_tpu_torch.models.losses import mvs4net_loss
    from mvster_tpu_torch.tools import train

    maybe_initialize_distributed("cuda")
    dev = rank_device("cuda")
    _reset_counts()
    result = train.main(argv)
    torch.cuda.synchronize()
    launches = _launch_counts()

    batch = dtu_batch(argv[argv.index("--trainpath") + 1], dev)
    steps = {}
    for name in ("ddp", "plain"):
        model = MVS4Net(MVS4NetConfig.dtu_default())
        model.load_state_dict(init_state_dict(model, seed=1), strict=True)
        model.to(dev)
        net = (DistributedDataParallel(model, device_ids=[dev.index], broadcast_buffers=False)
               if name == "ddp" else model)
        step = make_train_step(net, torch.optim.Adam(model.parameters(), lr=1e-3), mvs4net_loss,
                               dict(LOSS_KW, ot_backend="pallas"))
        steps[name] = lambda step=step: step(batch)
        steps[name]()
        steps[name]()
    ms = {name: [] for name in steps}
    for name in ("ddp", "plain", "plain", "ddp"):
        ms[name].append(cuda_ms(steps[name], iters=5, warmup=0))
    with open(out, "w") as f:
        json.dump(dict(result, backend=dist.get_backend(), world=dist.get_world_size(),
                       launches=launches, step_ms=ms), f)
    dist.destroy_process_group()
    return 0


def phase20_ddp_entry(dev, tmp, root, card):
    """python -m torch.distributed.run --standalone --nproc_per_node 1 at
    DTU-mid, global batch 2, --ot_backend pallas, one epoch on phase 8's
    tree; the process runs tools.train.main (ddp_entry).  Returns its
    kernel launches."""
    out = os.path.join(tmp, "ddp_entry.json")
    argv = ["--trainpath", root, "--trainlist", f"{root}/train.txt", "--testlist",
            f"{root}/train.txt", "--logdir", os.path.join(tmp, "log_ddp"),
            "--ot_backend", "pallas", *TRAIN_FLAGS]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "chip_smoke", DDP_ENTRY, out, *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    run_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"torchrun exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    if (res["backend"], res["world"], res["world_size"], res["rank"]) != ("nccl", 1, 1, 0):
        raise AssertionError(f"process group {res['backend']} of {res['world']}")
    steps = res["steps"]
    val_batches = -(-NVIEWS * 7 // BATCH)
    views = 4 * (NVIEWS - 1)
    expect = dict(K1=4 * val_batches, K2=views * steps, K3=views * steps,
                  K4=4 * steps + 4 * val_batches, K5=4 * steps)
    if steps != NVIEWS * 7 // BATCH or res["launches"] != expect:
        raise AssertionError(f"{steps} steps, launches {res['launches']}, expected {expect}")
    if not np.isfinite(res["val"]["loss"]):
        raise AssertionError(f"val {res['val']}")

    config = MVS4NetConfig.dtu_default()
    state = torch.load(res["checkpoint"], map_location="cpu", weights_only=True)["model"]
    if any(k.startswith("module.") for k in state):
        raise AssertionError("the checkpoint holds DDP's module. keys")
    model = MVS4Net(config)
    model.load_state_dict(state, strict=True)
    model.to(dev).eval()
    s = synthetic_sample(20, nviews=NVIEWS, h=H, w=W)
    request = {"imgs": s["imgs"][0], "depth_values": s["depth_values"][0],
               "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()}}
    warp_correlate.fused_cost_volume.launches = 0
    served = list(infer_views(model, [request]))
    k1 = warp_correlate.fused_cost_volume.launches
    if k1 != 4 or not np.isfinite(served[0][1]["depth"]).all():
        raise AssertionError(f"checkpoint serving: {k1} K1 launches")
    ms = res["step_ms"]
    log(f"[20a ddp entry] torchrun --nproc_per_node 1 -m tools.train: NCCL, world 1, {steps} "
        f"steps of global batch {BATCH} at {H}x{W}, {NVIEWS} views, --ot_backend pallas + a "
        f"val pass of {val_batches} batches in {run_s:.1f} s (process start and nvcc-free "
        f"library load included); val loss {res['val']['loss']:.4f}; launches "
        f"{res['launches']} (per step {views} K2, {views} K3, 4 K4, 4 K5; per val batch 4 "
        f"K1, 4 K4); the checkpoint has no module. keys, loaded strictly and served a "
        f"request through {k1} K1 launches | {card}")
    log(f"[20a times] DTU-mid train step, batch {BATCH}, pallas, Adam, in that process (mean "
        f"of 5 after 2 warm-up, CUDA events, in turns ddp, plain, plain, ddp): DDP (NCCL, "
        f"world 1) " + " / ".join(f"{x:.2f}" for x in ms["ddp"]) + " ms, unwrapped "
        + " / ".join(f"{x:.2f}" for x in ms["plain"]) + f" ms | {card}")
    return res["launches"]


def _gloo_batch(root):
    """The DTU tree's first 4 training samples (numpy), rank 1's two with
    the left half of every stage's mask cut, so the ranks' counts differ."""
    from mvster_tpu_torch.data import MVSLoader
    from mvster_tpu_torch.data.dtu import DTUDataset

    ds = DTUDataset(root, f"{root}/train.txt", "train", NVIEWS, 1.06, seed=1)
    batch = next(iter(MVSLoader(ds, 2 * BATCH, prefetch=0)))
    batch = {k: v for k, v in batch.items() if not isinstance(v, (list, str))}
    batch["mask"] = {k: v.copy() for k, v in batch["mask"].items()}
    for v in batch["mask"].values():
        v[BATCH:, :, : v.shape[2] // 2] = 0
    return batch


def _shard(batch, rank):
    if isinstance(batch, dict):
        return {k: _shard(v, rank) for k, v in batch.items()}
    return batch[rank * BATCH:(rank + 1) * BATCH]


def _sgd_step(model, batch):
    """One SGD step (lr 1e-3) of dtu_default() from tools.train's initial
    weights (seed 1) with --ot_backend pallas: (scalars, state after, ms)."""
    from mvster_tpu_torch.models.losses import mvs4net_loss
    from mvster_tpu_torch.train.loop import device_batch

    module = getattr(model, "module", model)
    step = make_train_step(model, torch.optim.SGD(module.parameters(), lr=DDP_LR), mvs4net_loss,
                           dict(LOSS_KW, ot_backend="pallas"))
    dev = next(module.parameters()).device
    b = device_batch(batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    scalars, _ = step(b)
    end.record()
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in scalars.items()},
            {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()},
            start.elapsed_time(end), torch.cuda.max_memory_allocated(dev))


def _seeded_model(dev):
    model = MVS4Net(MVS4NetConfig.dtu_default())
    model.load_state_dict(init_state_dict(model, seed=1), strict=True)
    return model.to(dev)


def gloo_rank(tmp):
    """Phase 20 (b), one of two ranks on the one card: join over gloo from
    torchrun's environment variables, one SGD step of DDP on this rank's
    shard, then three more timed; results to <tmp>/rank<r>.pt."""
    import pickle

    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rank, world = maybe_initialize_distributed(dev, backend="gloo")
    with open(os.path.join(tmp, "gloo_batch.pkl"), "rb") as f:
        batch = _shard(pickle.load(f), rank)
    model = DistributedDataParallel(_seeded_model(dev), device_ids=[0], broadcast_buffers=False)
    scalars, state, first_ms, peak = _sgd_step(model, batch)
    ms = [_sgd_step(model, batch)[2] for _ in range(3)]
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(dict(rank=rank, world=world, backend=dist.get_backend(), scalars=scalars,
                         state=state, first_ms=first_ms, ms=ms, peak=peak), f)
    dist.destroy_process_group()
    return 0


def phase20_gloo_pair(dev, tmp, root, card):
    """Two processes on the one card over gloo, batch 2 each (global 4),
    one SGD step, against one process's batch-4 step on the card."""
    import pickle
    import socket

    batch = _gloo_batch(root)
    with open(os.path.join(tmp, "gloo_batch.pkl"), "wb") as f:
        pickle.dump(batch, f)
    one, one_state, one_ms, one_peak = _sgd_step(_seeded_model(dev), batch)
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(DDP_WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen([sys.executable, "-m", "chip_smoke", GLOO_RANK, tmp], cwd=ROOT,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(DDP_WORLD)]
    logs = []
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        if p.returncode:
            raise AssertionError(f"gloo rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    ranks = []
    for r in range(DDP_WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    if [(x["rank"], x["world"], x["backend"]) for x in ranks] != [(0, 2, "gloo"), (1, 2, "gloo")]:
        raise AssertionError(f"groups {[(x['rank'], x['world'], x['backend']) for x in ranks]}")
    worst_scalar = worst_param = worst_stat = 0.0
    flips = set()
    for x in ranks:
        for key, want in one.items():
            diff = abs(x["scalars"][key] - want)
            if diff > 1e-5 * abs(want) + 1e-7:
                # a pixel fraction: a depth or hypothesis within float32
                # rounding of its threshold lands on either side under
                # either batch composition (cuDNN picks other algorithms
                # at batch 2 and 4; untrained weights leave near-ties in
                # the depth argmax)
                if not key.startswith(PIXEL_FRACTIONS) or diff > 1e-5 * abs(want) + PIXEL_ATOL:
                    raise AssertionError(f"{key}: {x['scalars'][key]} vs one process {want}")
                flips.add(key)
            worst_scalar = max(worst_scalar, diff / max(abs(want), 1e-30))
    a, b = ranks[0]["state"], ranks[1]["state"]
    for key, want in one_state.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"ranks differ: {key}")
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(a[key], want, rtol=1e-4, atol=1e-5, err_msg=key)
            worst_stat = max(worst_stat, float(np.abs(a[key] - want).max()))
        else:
            np.testing.assert_allclose(a[key], want, rtol=1e-2, atol=1e-5, err_msg=key)
            worst_param = max(worst_param, float(np.abs(a[key] - want).max()))
    log(f"[20b gloo pair] 2 ranks on the one card over gloo, DTU-mid {H}x{W}, {NVIEWS} views, "
        f"batch {BATCH} each (global {2 * BATCH}; rank 1's masks halved), pallas, one SGD step "
        f"(lr {DDP_LR}) vs one process's batch-{2 * BATCH} step on the card: loss "
        f"{ranks[0]['scalars']['loss']:.6f} / {ranks[1]['scalars']['loss']:.6f} vs "
        f"{one['loss']:.6f}, worst scalar rel diff {worst_scalar:.2e} (rtol 1e-5; the pixel "
        f"fractions atol {PIXEL_ATOL} more, taken by {sorted(flips) or 'none'}); parameters "
        f"max|d| {worst_param:.2e} (rtol 1e-2, atol 1e-5); BatchNorm running statistics "
        f"bitwise equal across the ranks, max|d| {worst_stat:.2e} vs one process (rtol 1e-4, "
        f"atol 1e-5) | {card}")
    log(f"[20b times] gloo on one card, not a DDP speed (two processes share the SMs, gloo "
        f"stages every collective through the host): step ms (CUDA events, first, then 3) "
        + "; ".join(f"rank {x['rank']} {x['first_ms']:.1f}, "
                    + " / ".join(f"{m:.1f}" for m in x["ms"])
                    + f", peak {x['peak'] / 2**30:.3f} GiB" for x in ranks)
        + f"; one process batch {2 * BATCH}: first step {one_ms:.1f} ms, peak "
        f"{one_peak / 2**30:.3f} GiB | {card}")


# phase 21: every model variant of the JAX package beyond dtu_default's
# (tests/_torch_parity.VARIANTS), with seeded random weights at dtu_default's
# widths: (a) serving at DTU-mid, (b) the card against the CPU at
# VARIANT_H x VARIANT_W, (c) one train step at DTU-mid
VARIANT_H, VARIANT_W, VARIANT_VIEWS = 128, 192, 3
VARIANT_REQUESTS = 2
# the training entry point by its flags, three variants at once
VARIANT_TRAIN_FLAGS = ["--reg_mode", "reg3d", "--pos_enc", "2", "--ASFF"]


def _variant_serve(name, model, dev):
    """(a) infer_views answers VARIANT_REQUESTS requests at DTU-mid with
    every count at 0 just before (K7 4 a forward with --dcn); returns the
    counts."""
    requests = []
    for seed in range(VARIANT_REQUESTS):
        s = synthetic_sample(210 + seed, nviews=NVIEWS, h=H, w=W)
        requests.append({"imgs": s["imgs"][0], "depth_values": s["depth_values"][0],
                         "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()}})
    _reset_counts()
    served = list(infer_views(model, requests, eval_batch=1))
    torch.cuda.synchronize()
    counts = dict(_launch_counts(), K7=deform_conv.deform_conv.launches)
    k7 = 4 * VARIANT_REQUESTS if VARIANTS[name].get("dcn") else 0  # a head each of 4
    if len(served) != VARIANT_REQUESTS or counts != dict(
            K1=4 * VARIANT_REQUESTS, K2=0, K3=0, K4=0, K5=0, K7=k7):
        raise AssertionError(f"{name}: {len(served)} requests served, launches {counts}")
    for req, (_, res) in zip(requests, served):
        dmin, dmax = req["depth_values"][0], req["depth_values"][-1]
        d1 = res["stage1_depth"]
        if not np.isfinite(res["depth"]).all() or res["depth"].shape != (1, H, W):
            raise AssertionError(f"{name}: served depth {res['depth'].shape}, not finite")
        if d1.min() < dmin * (1 - 1e-6) or d1.max() > dmax * (1 + 1e-6):
            raise AssertionError(f"{name}: stage-1 depth [{d1.min()}, {d1.max()}] "
                                 f"outside [{dmin}, {dmax}]")
    return counts, [r["seconds"] for _, r in served]


def _variant_card_vs_cpu(name, model_cpu, dev):
    """(b) the same model at VARIANT_H x VARIANT_W on the card and on the
    CPU plain path; these launches count on no path."""
    sample = synthetic_sample(213, nviews=VARIANT_VIEWS, h=VARIANT_H, w=VARIANT_W)
    with torch.inference_mode():
        got = to_numpy_tree(copy.deepcopy(model_cpu).to(dev)(*model_inputs(sample, dev)))
        want = to_numpy_tree(model_cpu(*model_inputs(sample, "cpu")))
    if name == "bf16":
        assert_bf16_close(want, got)
    else:
        assert_stage_close(want, got)
    return float(np.abs(got["stage1"]["attn_weight"] - want["stage1"]["attn_weight"]).max())


def _variant_step(name, overrides, batch, dev):
    """(c) one train step of dtu_default(**overrides) (mono on) at DTU-mid,
    batch 2, --ot_backend pallas, through dist/train_step, with every count
    at 0 just before (K7 4 with --dcn); returns (loss, counts)."""
    from mvster_tpu_torch.models.losses import mvs4net_loss

    model = MVS4Net(MVS4NetConfig.dtu_default(**overrides))
    model.load_state_dict(init_state_dict(model, seed=21), strict=True)
    model.to(dev)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), mvs4net_loss,
                           dict(LOSS_KW, ot_backend="pallas"))
    _reset_counts()
    scalars, _ = step(batch)
    torch.cuda.synchronize()
    counts = dict(_launch_counts(), K7=deform_conv.deform_conv.launches)
    loss = float(scalars["loss"])
    graded = {k for k, p in model.named_parameters() if p.grad is not None and p.grad.any()}
    moved = {k for k, p in model.named_parameters() if not torch.equal(p.detach(), before[k])}
    per_step = 4 * (NVIEWS - 1)
    k7 = 4 if overrides.get("dcn") else 0  # the forward's; its backward is plain
    if counts != dict(K1=0, K2=per_step, K3=per_step, K4=4, K5=4, K7=k7):
        raise AssertionError(f"{name}: train-step launches {counts}")
    if not np.isfinite(loss) or not graded or moved != graded:
        raise AssertionError(f"{name}: loss {loss}, {len(graded)} tensors with a gradient, "
                             f"{len(moved)} moved")
    return loss, counts, len(moved)


def _bf16_times(dev, batch, card):
    """The bf16 and float32 forward (DTU-mid, 5 views, CUDA events over 20
    iterations) and train step (batch 2, 5 steps after 2 of warm-up), in
    turns f32, bf16, bf16, f32, with each one's peak memory."""
    from mvster_tpu_torch.models.losses import mvs4net_loss

    sample = synthetic_sample(0, nviews=NVIEWS, h=H, w=W)
    inputs = model_inputs(sample, dev)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        fwd = build_model(seed=0, compute_dtype=dtype).to(dev)
        model = MVS4Net(MVS4NetConfig.dtu_default(compute_dtype=dtype))
        model.load_state_dict(init_state_dict(model, seed=1), strict=True)
        model.to(dev)
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                               mvs4net_loss, dict(LOSS_KW, ot_backend="pallas"))
        runs[dtype] = dict(model=fwd, fwd=lambda fwd=fwd: fwd(*inputs),
                           step=lambda step=step: step(batch),
                           fwd_ms=[], step_ms=[], fwd_mb=0.0, step_mb=0.0)
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        r = runs[dtype]
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            r["fwd_ms"].append(cuda_ms(r["fwd"], iters=20))
        r["fwd_mb"] = max(r["fwd_mb"], torch.cuda.max_memory_allocated() / 2**20)
        torch.cuda.reset_peak_memory_stats()
        r["step_ms"].append(cuda_ms(r["step"], iters=5, warmup=2))
        r["step_mb"] = max(r["step_mb"], torch.cuda.max_memory_allocated() / 2**20)
    f32, bf16 = runs["float32"], runs["bfloat16"]
    log(f"[21 bf16 times] forward {H}x{W}, {NVIEWS} views, batch 1 (20 iterations, in "
        f"turns f32 bf16 bf16 f32): f32 {f32['fwd_ms']} ms, bf16 {bf16['fwd_ms']} ms, "
        f"peak {f32['fwd_mb']:.1f} / {bf16['fwd_mb']:.1f} MiB; train step batch {BATCH}, "
        f"--ot_backend pallas (5 steps after 2 of warm-up): f32 {f32['step_ms']} ms, bf16 "
        f"{bf16['step_ms']} ms, peak {f32['step_mb']:.1f} / {bf16['step_mb']:.1f} MiB | {card}")
    for dtype, r in runs.items():
        profile_forward(r["model"], inputs, float(np.mean(r["fwd_ms"])), card,
                        label=f"21 {dtype} forward")
    return runs


def phase21_variants(dev, tmp, root, ckpt, serve, card):
    """Every variant through (a) serving, (b) the card against the CPU and
    (c) one train step; then tools.train.main and tools.test.main by their
    flags, and the bf16 times.  Returns the kernels' launches over (a) and
    (c) of every variant and the two entry points, and K7's over (a) and
    over (c)."""
    from mvster_tpu_torch.tools import train

    t0 = time.perf_counter()
    batch = dtu_batch(root, dev)
    total = dict(K1=0, K2=0, K3=0, K4=0, K5=0, K7=0)
    k7_paths = dict(serve=0, train=0)
    for name, overrides in VARIANTS.items():
        tv = time.perf_counter()
        model_cpu = build_model(seed=21, **overrides)
        model = copy.deepcopy(model_cpu).to(dev)
        counts, seconds = _variant_serve(name, model, dev)
        err = _variant_card_vs_cpu(name, model_cpu, dev)
        loss, step_counts, moved = _variant_step(name, overrides, batch, dev)
        for k in total:
            total[k] += counts[k] + step_counts[k]
        k7_paths["serve"] += counts["K7"]
        k7_paths["train"] += step_counts["K7"]
        del model, model_cpu
        torch.cuda.empty_cache()
        log(f"[21 variant {name}] {overrides}: served {VARIANT_REQUESTS} requests at {H}x{W}, "
            f"{NVIEWS} views, {counts['K1']} K1 and {counts['K7']} K7 launches, latency ms "
            + ", ".join(f"{1e3 * x:.2f}" for x in seconds)
            + f"; card vs CPU at {VARIANT_H}x{VARIANT_W}, {VARIANT_VIEWS} views: "
            f"{'assert_bf16_close' if name == 'bf16' else 'stage comparator'} holds, stage-1 "
            f"attention max|d| {err:.2e}; train step batch {BATCH}: loss {loss:.4f}, "
            f"{moved} tensors moved, launches {step_counts}; {time.perf_counter() - tv:.1f} s")

    # the training entry point by its flags, one epoch of phase 8's tree
    logdir = os.path.join(tmp, "log_variants")
    argv = ["--trainpath", root, "--trainlist", f"{root}/train.txt", "--testlist",
            f"{root}/train.txt", "--logdir", logdir, "--ot_backend", "pallas",
            *VARIANT_TRAIN_FLAGS, *TRAIN_FLAGS]
    _reset_counts()
    result = train.main(argv)
    torch.cuda.synchronize()
    counts = _launch_counts()
    steps, per_step = result["steps"], 4 * (NVIEWS - 1)
    if counts["K2"] != per_step * steps or counts["K3"] != per_step * steps \
            or counts["K5"] != 4 * steps:
        raise AssertionError(f"tools.train.main {VARIANT_TRAIN_FLAGS}: {steps} steps, {counts}")
    losses = [r["loss"] for r in _jsonl(os.path.join(logdir, "metrics.jsonl"))
              if r["mode"] == "train"]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"tools.train.main {VARIANT_TRAIN_FLAGS}: losses {losses}")
    for k in counts:
        total[k] += counts[k]
    config = MVS4NetConfig.dtu_default(reg_net="reg3d", pos_enc=2, asff=True)
    trained = MVS4Net(config)
    trained.load_state_dict(load_reference_ckpt(result["checkpoint"], config), strict=True)
    log(f"[21 train entry] tools.train.main {' '.join(VARIANT_TRAIN_FLAGS)} --ot_backend "
        f"pallas: {steps} steps of batch {BATCH} at {H}x{W} + a val pass, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}, launches {counts}; the checkpoint loaded "
        f"strictly into the variant")

    # the serving entry point by its flags, bf16 on phase 17's scan
    argv = ["--testpath", serve["root"], "--testlist", serve["scan"], "--loadckpt", ckpt,
            "--outdir", os.path.join(tmp, "dtu_out_bf16"), *SERVE_FLAGS, "--num_view", "5",
            "--thres_view", "4", "--conf", "0.5", "--compute_dtype", "bfloat16"]
    times, k1, total_s = _serve(argv, card, "phase 21")
    if k1 != 4 * DTU_VIEWS or times["views"] != DTU_VIEWS:
        raise AssertionError(f"bf16 tools.test.main: {times['views']} views, {k1} K1 launches")
    from mvster_tpu_torch.data.pfm import read_pfm

    for v in range(DTU_VIEWS):
        m = read_pfm(os.path.join(tmp, "dtu_out_bf16", serve["scan"], "depth_est",
                                  f"{v:08d}.pfm"))[0]
        if m.shape != (SERVE_H, SERVE_W) or not np.isfinite(m).all():
            raise AssertionError(f"bf16 depth {v}: shape {m.shape}")
    total["K1"] += k1
    log(f"[21 test entry] tools.test.main --compute_dtype bfloat16 on phase 17's scan at "
        f"{SERVE_H}x{SERVE_W}: {k1} K1 launches, {DTU_VIEWS} finite depth maps; forward "
        f"{times['forward']:.3f} s (phase 17's float32: {serve['times']['forward']:.3f} s), "
        f"fusion {times['fusion'][serve['scan']]:.3f} s | {card}")
    _bf16_times(dev, batch, card)
    log(f"[21 variants] {len(VARIANTS)} variants, both entry points and the bf16 times in "
        f"{time.perf_counter() - t0:.1f} s; launches over the phase's paths {total}, K7's by "
        f"path {k7_paths}")
    return total, k7_paths


# phase 22: the last modules of the JAX package.  (a) image-row sharded
# inference (dist/spatial.py), gloo ranks on the one card (NCCL puts no two
# ranks on one device): spatial 4 at DTU-mid, then spatial 2 at DTU-mid and
# at DTU's raw resolution; (b) tools.test's --vis_ETA / --vis_mono dumps
# (K2); (c) the sg_cuts hook on the DTU-mid train step
SPATIAL_RANK = "--spatial-rank"
RAW_H, RAW_W = 1152, 1600  # DTU's raw 1200x1600 at multiples of 64
SPATIAL_RUNS = (("mid_s4", H, W, 4), ("mid_s2", H, W, 2), ("raw_s2", RAW_H, RAW_W, 2))
SPATIAL_TIMED = 3  # steps timed a rank, after the counted one
STAGE_KEYS = ("attn_weight", "hypo_depth", "depth", "photometric_confidence")
# (b): the card against --device cpu at a read size the CPU serves quickly;
# a pixel's attention volume depends on its own hypotheses and the features
# alone, so it is compared where the two runs' hypotheses agree (a near-tied
# argmax moves a later stage's window), and that must be at least VIS_SHARE
# of the pixels (measured: 100.00% at every stage; a share of a percent
# left to near-tied argmaxes)
VIS_MAX_H, VIS_MAX_W = 384, 512
VIS_TOL, VIS_SHARE = 1e-3, 0.99
SG_CUTS = ("none", "fpn", "mono", "warp", "cost_volume", "logits")
# the parameters wholly upstream of a cut under the published loss weights
# (l1ot_lw (0, 1): the mono decoder's L1 weighs 0, so its path carries zeros)
SG_UPSTREAM = {"none": (), "fpn": ("feature.",), "mono": ("mono_depth_decoder.",),
               "warp": (), "cost_volume": ("feature.", "mono_depth_decoder."),
               "logits": ("reg.",)}
# ... and the modules that still get a gradient (under "logits" none: the
# loss reaches the parameters only through the logits and the 0-weighed L1)
SG_DOWNSTREAM = {"none": ("feature.", "reg."), "fpn": ("reg.",), "mono": ("feature.", "reg."),
                 "warp": ("feature.", "reg."), "cost_volume": ("reg.",), "logits": ()}


def _spatial_run(model, sample, n, dev):
    """One rank's part of a spatial-n run: the step (make_spatial_infer_step,
    the entry point) with every count at 0 just before, its forward's stage
    outputs (caught by a hook on the model) gathered, then SPATIAL_TIMED
    steps timed with their peak memory."""
    from mvster_tpu_torch.dist import spatial

    groups = spatial.make_2d_groups(1, n)
    inputs = model_inputs(sample, "cpu")  # the step moves the band's rows alone
    step = spatial.make_spatial_infer_step(model, groups)
    outs = []
    hook = model.register_forward_hook(lambda mod, args, out: outs.append(out))
    _reset_counts()
    try:
        depth, conf = step(*inputs)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    launches = _launch_counts()
    (out,) = outs
    if not (torch.equal(depth, out["stage4"]["depth"])
            and torch.equal(conf, out["stage4"]["photometric_confidence"])):
        raise AssertionError(f"spatial {n}: the step's outputs are not its forward's stage 4")
    gathered = {f"stage{s}": {k: spatial.gather_rows(out[f"stage{s}"][k], groups).cpu().numpy()
                              for k in STAGE_KEYS} for s in range(1, 5)}
    del out, outs
    ms = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(SPATIAL_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*inputs)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(band=groups.band, launches=launches, depth=depth.cpu().numpy(),
                conf=conf.cpu().numpy(), gathered=gathered, ms=ms,
                peak=torch.cuda.max_memory_allocated(dev))


def spatial_rank(tmp):
    """Phase 22 (a), one of four processes on the one card over gloo: the
    spatial-4 run in a world of 4, then ranks 0 and 1 the spatial-2 runs in
    a world of their own; results to <tmp>/spatial_rank<r>.pkl."""
    import pickle

    import torch.distributed as dist

    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with open(os.path.join(tmp, "spatial_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    model = build_model(seed=0).to(dev)
    rank, _ = maybe_initialize_distributed(dev, backend="gloo")
    out = {}
    for name, _, _, n in SPATIAL_RUNS:
        if rank >= n:
            break
        if dist.is_initialized() and dist.get_world_size() != n:
            dist.destroy_process_group()
            os.environ.update(WORLD_SIZE=str(n), MASTER_PORT=str(inputs["port"]))
            maybe_initialize_distributed(dev, backend="gloo")
        out[name] = _spatial_run(model, inputs[name], n, dev)
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"spatial_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def k1_on_band(dev, h, w, n, seed):
    """K1 on the last of n bands of an h x w forward's four stages (dtu_default's
    C, D and G, 4 sources; row0 = (n - 1) rows, the sources whole: Hs = n
    rows) against its plain version, both attention modes, at atol/rtol
    KERNEL_TOL, and against the rows of the whole-image launch, bitwise;
    returns the largest |kernel - plain|.  Called after the path's counts
    were read."""
    err = 0.0
    for si, (_, _, c, d, g) in enumerate(STAGES):
        hs, ws = h >> (3 - si), w >> (3 - si)
        rows = hs // n
        row0 = (n - 1) * rows
        inp = stage_inputs(seed + si, hs, ws, c, d, nsrc=NVIEWS - 1)
        ref, src, ref_proj, src_projs, hypo = (
            t(inp[k], dev) for k in ("ref", "src", "ref_proj", "src_projs", "hypo"))
        band = slice(row0, row0 + rows)
        args = (ref[:, band].contiguous(), src, ref_proj, src_projs,
                hypo[:, :, band].contiguous(), g, 2.0)
        for fuse in (True, False):
            got = warp_correlate.fused_cost_volume(*args, fuse, row0)
            want = warp_correlate.fused_cost_volume_plain(*args, fuse, row0)
            whole = warp_correlate.fused_cost_volume(ref, src, ref_proj, src_projs, hypo,
                                                     g, 2.0, fuse)
            torch.cuda.synchronize()
            if got.shape != (1, d, rows, ws, g) or not torch.isfinite(got).all():
                raise AssertionError(f"{h}x{w} band stage{si + 1}: {tuple(got.shape)}")
            torch.testing.assert_close(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
            if not torch.equal(got, whole[:, :, band]):
                raise AssertionError(f"{h}x{w} band stage{si + 1}: not the whole launch's rows")
            err = max(err, (got - want).abs().max().item())
        del args, got, want, whole, ref, src, hypo
    torch.cuda.empty_cache()
    return err


def phase22_spatial(dev, tmp, model, mid_out, card):
    """(a) the spatial step as gloo ranks on the one card against the
    single-process card forward of the same weights (phase 4's model and,
    at DTU-mid, its forward), by the stage comparator; K1 on a band against
    plain.  Returns (K1 launches over the runs, K1's largest error)."""
    import pickle
    import socket

    t0 = time.perf_counter()
    samples = {"mid": synthetic_sample(0, nviews=NVIEWS, h=H, w=W),
               "raw": synthetic_sample(22, nviews=NVIEWS, h=RAW_H, w=RAW_W)}
    single = {}
    for res, sample in samples.items():
        inputs = model_inputs(sample, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.inference_mode():
            out = mid_out if res == "mid" else to_numpy_tree(model(*inputs))
            fwd_ms = cuda_ms(lambda: model(*inputs), iters=SPATIAL_TIMED, warmup=1)
        single[res] = dict(out=out, ms=fwd_ms, peak=torch.cuda.max_memory_allocated(dev))
        del inputs
    torch.cuda.empty_cache()
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    with open(os.path.join(tmp, "spatial_inputs.pkl"), "wb") as f:
        pickle.dump(dict({name: samples[name[:3]] for name, *_ in SPATIAL_RUNS},
                         port=ports[1]), f)
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]))
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen([sys.executable, "-m", "chip_smoke", SPATIAL_RANK, tmp], cwd=ROOT,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        if p.returncode:
            raise AssertionError(f"spatial rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"spatial_rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    run_s = time.perf_counter() - t0
    k1_total, err = 0, 0.0
    for name, h, w, n in SPATIAL_RUNS:
        parts = [ranks[r][name] for r in range(n)]
        ref = single[name[:3]]
        for r, part in enumerate(parts):
            if part["band"] != r or part["launches"] != dict(K1=4, K2=0, K3=0, K4=0, K5=0):
                raise AssertionError(f"{name} rank {r}: band {part['band']}, "
                                     f"launches {part['launches']}")
            if part["depth"].shape != (1, h // n, w) or part["conf"].shape != (1, h // n, w):
                raise AssertionError(f"{name} rank {r}: {part['depth'].shape}")
            if not (np.isfinite(part["depth"]).all() and np.isfinite(part["conf"]).all()):
                raise AssertionError(f"{name} rank {r}: non-finite depth or confidence")
            k1_total += part["launches"]["K1"]
        got = dict(parts[0]["gathered"], depth=parts[0]["gathered"]["stage4"]["depth"])
        assert_stage_close(ref["out"], got)
        worst = max(np.abs(got[f"stage{s}"]["attn_weight"]
                           - ref["out"][f"stage{s}"]["attn_weight"]).max() for s in range(1, 5))
        band_err = k1_on_band(dev, h, w, n, seed=220)
        err = max(err, band_err)
        log(f"[22a spatial] {name}: dtu_default(mono=False) at {h}x{w}, {NVIEWS} views, batch "
            f"1 as {n} gloo ranks on the one card (bands of {h // n} rows): "
            f"{sum(p['launches']['K1'] for p in parts)} K1 launches, matches the "
            f"single-process card forward by the stage comparator (attention max|d| "
            f"{worst:.3e}); peak memory a rank "
            + " / ".join(f"{p['peak'] / 2**20:.1f}" for p in parts)
            + f" MiB vs one process {ref['peak'] / 2**20:.1f} MiB; ms a step (host clock, "
            f"{SPATIAL_TIMED} after the counted one; gloo stages every exchange through "
            f"the host: not a scaling number) "
            + "; ".join(f"rank {r} " + " / ".join(f"{m:.1f}" for m in p["ms"])
                        for r, p in enumerate(parts))
            + f", one process {ref['ms']:.2f} (CUDA events); K1 on the last band (row0 "
            f"{(n - 1) * (h // n) // 8}..{(n - 1) * (h // n)} by stage, whole sources) vs "
            f"plain max|d| {band_err:.3e} (atol=rtol={KERNEL_TOL}), bitwise the whole "
            f"launch's rows | {card}")
    log(f"[22a spatial] {run_s:.1f} s for the runs (4 processes started once)")
    return k1_total, err


def _vis_dumps(outdir, scan):
    return {os.path.relpath(os.path.join(d, f), outdir): np.load(os.path.join(d, f))
            for kind in ("vis_ETA", "vis_mono")
            for d, _, fs in os.walk(os.path.join(outdir, scan, kind)) for f in fs}


def phase22_vis(dev, tmp, ckpt, serve, model, card):
    """(b) tools.test.main --vis_ETA --vis_mono on phase 17's scan at its
    flags, every count at 0 just before: 28 K1 and 4 stages x 4 sources x 7
    views K2 launches; then its save_depth with the flags on the card and
    with --device cpu at VIS_MAX_H x VIS_MAX_W, the dumps held against each
    other.  That comparison takes phase 4's seeded weights (`model`, whose
    depth softmax is decisive, as the stage comparator wants): phase 8's
    checkpoint, one epoch from the initial weights, leaves near-uniform
    attention, where float rounding alone picks a later stage's window
    (measured: stage-4 windows agreed on 8% of the pixels).  Returns the
    K2 launches."""
    from mvster_tpu_torch.tools import test as test_tool

    scan = serve["scan"]
    argv = ["--testpath", serve["root"], "--testlist", scan, "--loadckpt", ckpt,
            *SERVE_FLAGS, "--num_view", "5", "--thres_view", "4", "--conf", "0.5",
            "--vis_ETA", "--vis_mono"]
    outdir = os.path.join(tmp, "vis_out")
    _reset_counts()
    t0 = time.perf_counter()
    times = test_tool.main([*argv, "--outdir", outdir])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = _launch_counts()
    k2 = 4 * 4 * DTU_VIEWS
    if counts != dict(K1=4 * DTU_VIEWS, K2=k2, K3=0, K4=0, K5=0):
        raise AssertionError(f"vis: launches {counts}")
    k2_err = k2_on_cascade(dev, SERVE_H, SERVE_W, nsrc=4, seed=225)
    dumps = _vis_dumps(outdir, scan)
    if len(dumps) != 5 * DTU_VIEWS:
        raise AssertionError(f"vis: {len(dumps)} dumps")
    for path, a in dumps.items():
        want = ((1, SERVE_H, SERVE_W, 8) if "vis_mono" in path else None)
        if (want and a.shape != want) or not np.isfinite(a).all():
            raise AssertionError(f"{path}: {a.shape}")
        if "vis_ETA" in path and (a.shape[:2] != (4, 1)
                                  or np.abs(a.sum(axis=2) - 1).max() > 1e-5):
            raise AssertionError(f"{path}: {a.shape}, not a softmax over depth")

    seeded = os.path.join(tmp, "phase4_weights.ckpt")
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, seeded)
    small, hypos = {}, {}
    infer_views = test_tool.infer_views

    def capture(*a, **k):  # each view's stage hypotheses, as save_depth passes them on
        for sample, res in infer_views(*a, **k):
            hypos[device][sample["filename"]] = [res[f"stage{s}_hypo"] for s in range(1, 5)]
            yield sample, res

    for device in ("cuda", "cpu"):
        out_small = os.path.join(tmp, f"vis_{device}")
        args = test_tool.build_test_parser().parse_args(
            [*argv, "--outdir", out_small, "--max_h", str(VIS_MAX_H), "--max_w",
             str(VIS_MAX_W), "--device", device, "--loadckpt", seeded])
        config = test_tool.model_config_from_args(args)
        m = MVS4Net(config)
        m.load_state_dict(load_reference_ckpt(args.loadckpt, config), strict=True)
        hypos[device] = {}
        t1 = time.perf_counter()
        test_tool.infer_views = capture
        try:
            test_tool.save_depth(args, m.to(args.device).eval(), [scan])
        finally:
            test_tool.infer_views = infer_views
        small[device] = (_vis_dumps(out_small, scan), time.perf_counter() - t1)
    card_dumps, cpu_dumps = small["cuda"][0], small["cpu"][0]
    if sorted(card_dumps) != sorted(cpu_dumps) or len(card_dumps) != 5 * DTU_VIEWS:
        raise AssertionError(f"vis: {sorted(card_dumps)} vs {sorted(cpu_dumps)}")
    mono_err, eta_err, shares = 0.0, 0.0, {s: [] for s in range(1, 5)}
    for path, want in cpu_dumps.items():
        got = card_dumps[path]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{path}: {got.shape} vs {want.shape}")
        if "vis_mono" in path:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=path)
            mono_err = max(mono_err, float(np.abs(got - want).max()))
            continue
        view = os.path.basename(path)[:8]
        s = int(path[-10])  # ..._stage{s}_attn.npy
        name = next(f for f in hypos["cpu"] if os.path.basename(f).startswith(view))
        agree = np.all(np.isclose(hypos["cuda"][name][s - 1], hypos["cpu"][name][s - 1],
                                  rtol=1e-5), axis=1)  # (1, h, w)
        shares[s].append(float(agree.mean()))
        if agree.mean() < VIS_SHARE or (s == 1 and not agree.all()):
            raise AssertionError(f"{path}: the runs' hypotheses agree on {agree.mean():.2%}")
        sel = np.broadcast_to(agree[None, :, None], got.shape)
        np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=VIS_TOL, err_msg=path)
        eta_err = max(eta_err, float(np.abs(got[sel] - want[sel]).max()))
    log(f"[22b vis] tools.test.main --vis_ETA --vis_mono on phase 17's scan ({SERVE_H}x"
        f"{SERVE_W}, {DTU_VIEWS} views): {counts['K1']} K1 and {counts['K2']} K2 launches "
        f"(4 stages x 4 sources a view), {len(dumps)} dumps (vis_mono (1, {SERVE_H}, "
        f"{SERVE_W}, 8), vis_ETA softmaxes over depth), {total_s:.1f} s in main (forward "
        f"{times['forward']:.3f} s; writing the views and dumps {times['depth']:.3f} s); "
        f"K2 vs plain at this path's stages ({SERVE_H // 8}x{SERVE_W // 8} to "
        f"{SERVE_H}x{SERVE_W}, batch 1, 4 sources) max|d| {k2_err:.3e} (atol {K2_ATOL}); "
        f"save_depth with phase 4's weights at {VIS_MAX_H}x{VIS_MAX_W} on the card "
        f"({small['cuda'][1]:.1f} s) vs "
        f"--device cpu ({small['cpu'][1]:.1f} s): vis_mono max|d| {mono_err:.3e} (rtol=atol "
        f"1e-4), vis_ETA max|d| {eta_err:.3e} (atol {VIS_TOL}) on the pixels where the "
        f"runs' hypotheses agree, by stage at least "
        + ", ".join(f"{min(v):.2%}" for v in shares.values())
        + f" of them (>= {VIS_SHARE:.0%}, stage 1 all: a near-tied argmax moves a later "
        f"stage's window) | {card}")
    return counts["K2"], k2_err


def phase22_sg_cuts(dev, root, card):
    """(c) the DTU-mid train step (batch 2, --ot_backend pallas, Adam, f32,
    the published loss weights as scripts/probe_train_bwd.py takes them)
    under no cut and each sg_cuts cut: one counted step each (zero
    gradients upstream of the cut, gradients downstream, K3 only where a
    gradient reaches the warped sources), then 3 steps each by CUDA
    events, in turns.  Returns the launches summed over the counted
    steps."""
    from mvster_tpu_torch.models.losses import mvs4net_loss

    batch = dtu_batch(root, dev)
    steps, counts, losses = {}, {}, {}
    per_step = 4 * (NVIEWS - 1)
    for cut in SG_CUTS:
        model = MVS4Net(MVS4NetConfig.dtu_default(sg_cuts=() if cut == "none" else (cut,)))
        model.load_state_dict(init_state_dict(model, seed=1), strict=True)
        model.to(dev)
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                               mvs4net_loss, dict(LOSS_KW, ot_backend="pallas"))
        _reset_counts()
        scalars, _ = step(batch)
        torch.cuda.synchronize()
        counts[cut] = _launch_counts()
        losses[cut] = float(scalars["loss"])
        upstream = [k for k, _ in model.named_parameters() if k.startswith(SG_UPSTREAM[cut])]
        graded = {k for k, p in model.named_parameters() if p.grad is not None and p.grad.any()}
        if bool(upstream) != bool(SG_UPSTREAM[cut]) or graded & set(upstream):
            raise AssertionError(f"{cut}: gradients upstream {sorted(graded & set(upstream))}")
        if not np.isfinite(losses[cut]) or not all(
                any(k.startswith(prefix) for k in graded) for prefix in SG_DOWNSTREAM[cut]):
            raise AssertionError(f"{cut}: loss {losses[cut]}, gradients in "
                                 f"{sorted({k.split('.')[0] for k in graded})}")
        k3 = per_step if cut in ("none", "mono") else 0
        if (counts[cut]["K1"], counts[cut]["K2"], counts[cut]["K3"]) != (0, per_step, k3):
            raise AssertionError(f"{cut}: launches {counts[cut]}")
        steps[cut] = lambda step=step: step(batch)
    ms = {cut: [] for cut in SG_CUTS}
    for cut in SG_CUTS + SG_CUTS[::-1]:
        ms[cut].append(cuda_ms(steps[cut], iters=3, warmup=1))
    log(f"[22c sg_cuts] DTU-mid train step, batch {BATCH}, --ot_backend pallas, Adam, f32, "
        f"under each cut (one counted step: zero gradients upstream, K3 only where a "
        f"gradient reaches the warped sources): "
        + "; ".join(f"{cut} loss {losses[cut]:.4f} K2/K3/K4/K5 {counts[cut]['K2']}/"
                    f"{counts[cut]['K3']}/{counts[cut]['K4']}/{counts[cut]['K5']}"
                    for cut in SG_CUTS) + f" | {card}")
    log(f"[22c times] step ms by cut (3 steps after 1 of warm-up, CUDA events, in turns "
        f"{' '.join(SG_CUTS)} and back): "
        + "; ".join(f"{cut} " + " / ".join(f"{m:.2f}" for m in ms[cut]) for cut in SG_CUTS)
        + f" | {card}")
    return {k: sum(c[k] for c in counts.values()) for k in ("K2", "K3", "K4", "K5")}


def phase22(dev, tmp, root, ckpt, serve, model, mid_out, card):
    t0 = time.perf_counter()
    k1, k1_err = phase22_spatial(dev, tmp, model, mid_out, card)
    k2_vis, k2_err = phase22_vis(dev, tmp, ckpt, serve, model, card)
    cuts = phase22_sg_cuts(dev, root, card)
    log(f"[22] {time.perf_counter() - t0:.1f} s")
    return k1, k1_err, k2_vis, k2_err, cuts


# phase 23: the image-row sharded train step (dist/spatial.make_spatial_train_step)
# as gloo ranks on the one card (NCCL puts no two ranks on one device): (a) the
# DTU-mid train cell as data 2 x spatial 2 and as spatial 2, each with
# --ot_backend pallas and xla, and in bfloat16 compute; (b) DTU's raw
# resolution as spatial 2; (c) the weights after (a)'s spatial-2 pallas step
# served through K1 on a band
SPATIAL_TRAIN_RANK = "--spatial-train-rank"
F64, BF16 = torch.float64, torch.bfloat16
# (name, data, spatial, batch, ot_backend, dtype) of each run, in the order
# the ranks run them: the 4-rank runs first, then ranks 0 and 1 in a world of
# their own.  dtype None is float32, BF16 bfloat16 compute (float32
# parameters); the float64 runs (the plain warp: K2 takes float32 only) are
# each split's exact reference.  A name is <resolution>_<split>_<kind>
TRAIN_RUNS = (("mid_d2s2_pallas", 2, 2, BATCH, "pallas", None),
              ("mid_d2s2_xla", 2, 2, BATCH, "xla", None),
              ("mid_d2s2_f64", 2, 2, BATCH, "xla", F64),
              ("mid_s2_pallas", 1, 2, BATCH, "pallas", None), ("mid_s2_xla", 1, 2, BATCH, "xla", None),
              ("mid_s2_f64", 1, 2, BATCH, "xla", F64), ("mid_s2_bf16", 1, 2, BATCH, "pallas", BF16),
              ("raw_s2_pallas", 1, 2, 1, "pallas", None), ("raw_s2_f64", 1, 2, 1, "xla", F64))
# one process's steps on the card, each run's references: (resolution,
# ot_backend, dtype, moments).  moments: its BatchNorm takes the spatial
# ranks' arithmetic (flax_moments), the float32 runs' gradient reference
SINGLE_RUNS = (("mid", "pallas", None, False), ("mid", "xla", None, False),
               ("mid", "xla", F64, False), ("mid", "pallas", None, True),
               ("mid", "xla", None, True), ("mid", "pallas", BF16, False),
               ("raw", "pallas", None, False), ("raw", "xla", F64, False),
               ("raw", "pallas", None, True))
SERVED_RUN = "mid_s2_pallas"  # (c) serves the weights after this run's step
# the scalars downstream of a later stage's hypothesis window: a band's convs
# round in another order than the whole image's, so a near-tied stage argmax
# may move a pixel's window, and with it that pixel's share of a stage's OT
# loss, up to (D - 1) / N, and its final depth (measured on an H100 at
# DTU-mid: s2_c_loss up to 4.6e-5 apart, abs_depth_error 1.1e-5)
WINDOW_SCALARS = ("loss", "s1_c_loss", "s2_c_loss", "s3_c_loss", "abs_depth_error")
WINDOW_RTOL = 1e-4
# a float32 spatial gradient tensor's relative L2 distance from its split's
# float64 step against one process's with the same BatchNorm arithmetic:
# each tensor's at most F32_NOISE_RATIO times (check_grads' rule for two
# float32 steps), the median over the tensors at most F32_MEDIAN_RATIO
# times (tests/test_torch_spatial_train.py's ratio)
F32_NOISE_RATIO, F32_MEDIAN_RATIO = 10.0, 2.0
# a float64 spatial step's gradient tensor from one process's float64 step
# (measured on an H100 at DTU-mid: 9.3e-11; the Sinkhorn stays float32)
F64_GRAD_RTOL = 1e-7
# bf16 against one process's bf16 step (tests/test_torch_bf16.py's train
# step criteria): the loss's rtol, each stage loss's, and the median over
# the gradient tensors of the distance from float64, at most this times one
# process's
BF16_LOSS_RTOL, BF16_STAGE_RTOL, BF16_MEDIAN_RATIO = 1e-3, 5e-2, 1.5
SPATIAL_SEED = 23
# (b)'s peak device memory, predicted in PERF.md before the first run: one
# process's step and a rank's, GiB
RAW_PEAK_GUESS_GIB = (17.0, 9.5)
# (H, W, C, D, G) of each stage at DTU's raw 1152x1600
RAW_STAGES = [(RAW_H >> (3 - s), RAW_W >> (3 - s), c, d, g)
              for s, (_, _, c, d, g) in enumerate(STAGES)]


def _kind(backend, dtype):
    return {F64: "f64", BF16: "bf16"}.get(dtype, backend)


def _take(batch, rows, dtype=None):
    """The rows of a numpy batch as CPU tensors, float32 or `dtype`."""
    if isinstance(batch, dict):
        return {k: _take(v, rows, dtype) for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch[rows], dtype=np.float32)).to(dtype)


def _spatial_train_state():
    """phase 4's kind of seeded weights (a decisive depth softmax, perturbed
    running statistics) for dtu_default() with the mono branch on."""
    return {k: v.clone() for k, v in build_model(SPATIAL_SEED, mono=True).state_dict().items()}


def _train_model(state, dtype, dev, **overrides):
    """dtu_default(**overrides) with `state`: float32, float64, or bfloat16
    compute."""
    model = MVS4Net(MVS4NetConfig.dtu_default(
        **overrides, **({"compute_dtype": "bfloat16"} if dtype == BF16 else {})))
    model.load_state_dict(state, strict=True)
    return model.to(dev, F64 if dtype == F64 else torch.float32)


@contextlib.contextmanager
def flax_moments():
    """Within: one process's train-mode BatchNorm takes its moments as a step
    under a group of more than one rank does (nn/blocks._FlaxStats.
    _moments_forward: flax's variance E[x^2] - E[x]^2 from each channel's
    float32 sums) instead of through cuDNN, so one process rounds its
    statistics as the spatial ranks do."""
    from mvster_tpu_torch.nn import blocks

    forward = blocks._FlaxStats.forward

    def moments(self, x):
        if not self.training:
            return forward(self, x)
        x = x.to(self.weight.dtype)
        self._check_input_dim(x)
        return self._moments_forward(x)

    blocks._FlaxStats.forward = moments
    try:
        yield
    finally:
        blocks._FlaxStats.forward = forward


def _mid_batch(root):
    """The DTU tree's first training batch (DTU-mid, batch 2), numpy."""
    from mvster_tpu_torch.data import MVSLoader
    from mvster_tpu_torch.data.dtu import DTUDataset

    ds = DTUDataset(root, f"{root}/train.txt", "train", NVIEWS, 1.06, seed=1)
    mid = next(iter(MVSLoader(ds, BATCH, prefetch=0)))
    return {k: v for k, v in mid.items() if not isinstance(v, (list, str))}


def _spatial_train_batches(root):
    """The numpy batches: _mid_batch and a synthetic 1152x1600 sample with
    ground truth (batch 1)."""
    raw = synthetic_sample(SPATIAL_SEED, batch=1, nviews=NVIEWS, h=RAW_H, w=RAW_W,
                           with_gt=True)
    return {"mid": _mid_batch(root), "raw": raw}


def _serve_band(model, groups, batch, dev):
    """(c): make_spatial_infer_step on the first sample of `batch` with every
    count at 0 just before; its launches and its forward's stage outputs
    (caught by a hook on the model), gathered."""
    from mvster_tpu_torch.dist import spatial

    step = spatial.make_spatial_infer_step(model, groups)
    outs = []
    hook = model.register_forward_hook(lambda mod, args, out: outs.append(out))
    _reset_counts()
    try:
        step(batch["imgs"][:1], {k: v[:1] for k, v in batch["proj_matrices"].items()},
             batch["depth_values"][:1])
        torch.cuda.synchronize()
    finally:
        hook.remove()
    launches = _launch_counts()
    (out,) = outs
    gathered = {f"stage{s}": {k: spatial.gather_rows(out[f"stage{s}"][k], groups).cpu().numpy()
                              for k in STAGE_KEYS} for s in range(1, 5)}
    return {"launches": launches, "gathered": gathered}


def spatial_train_rank(tmp):
    """Phase 23, one of four processes on the one card over gloo: each run of
    TRAIN_RUNS that has this rank, one SGD step of make_spatial_train_step
    with every count at 0 just before; after SERVED_RUN, (c); after
    raw_s2_pallas, SPATIAL_TIMED more steps timed.  Results to
    <tmp>/spatial_train_rank<r>.pkl."""
    import pickle

    import torch.distributed as dist

    from mvster_tpu_torch.dist import spatial
    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the four processes share the host's cores: unbounded, their CPU
    # threads spin against each other and gloo's (measured on an 8-core CPU
    # rehearsal: 60x slower steps)
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    dev = torch.device("cuda", 0)
    with open(os.path.join(tmp, "spatial_train_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank, _ = maybe_initialize_distributed(dev, backend="gloo")
    out = {}
    for name, data, n, b, backend, dtype in TRAIN_RUNS:
        if rank >= data * n:
            break
        if dist.get_world_size() != data * n:
            dist.destroy_process_group()
            os.environ.update(WORLD_SIZE=str(data * n), MASTER_PORT=str(inputs["port"]))
            maybe_initialize_distributed(dev, backend="gloo")
        groups = spatial.make_2d_groups(data, n)
        share = b // data
        batch = _take(inputs[name[:3]], slice(groups.data_row * share,
                                              (groups.data_row + 1) * share),
                      F64 if dtype == F64 else None)
        model = _train_model(inputs["state"], dtype, dev)
        step = spatial.make_spatial_train_step(
            model, torch.optim.SGD(model.parameters(), lr=DDP_LR), groups,
            loss_kwargs=dict(LOSS_KW, ot_backend=backend))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        with plain_warp() if dtype == F64 else contextlib.nullcontext():
            scalars, images = step(batch)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        res = dict(band=groups.band, data_row=groups.data_row, launches=_launch_counts(),
                   scalars={k: float(v) for k, v in scalars.items()}, first_ms=first_ms,
                   peak=torch.cuda.max_memory_allocated(dev) - base,
                   depth_shape=tuple(images["depth_est"].shape),
                   after={k: v.cpu().numpy().copy() for k, v in model.state_dict().items()},
                   grads={k: p.grad.double().cpu().numpy() for k, p in model.named_parameters()},
                   finite=bool(all(torch.isfinite(v).all() for v in images.values())))
        del images
        if name == SERVED_RUN:
            res["serve"] = _serve_band(model.eval(), groups, batch, dev)
        if name == "raw_s2_pallas":
            ms = []
            for _ in range(SPATIAL_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            res["ms"] = ms
        out[name] = res
        del model, step, batch
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"spatial_train_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def _single_train_step(state, batch, backend, dev, dtype=None, timed=0, moments=False,
                       overrides=None, hypos=False):
    """One process's SGD step of the same weights on the whole batch (numpy),
    float32, float64 (the plain warp) or bfloat16 compute, with its
    BatchNorm under flax_moments if `moments`, of dtu_default(**overrides):
    the first step's scalars and gradients (with `hypos`, each stage's
    hypotheses too), the peak device memory above what was allocated
    before, and the host ms of the first step and of `timed` more."""
    b = {k: ({s: x.to(dev) for s, x in v.items()} if isinstance(v, dict) else v.to(dev))
         for k, v in _take(batch, slice(None), F64 if dtype == F64 else None).items()}
    model = _train_model(state, dtype, dev, **(overrides or {}))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=DDP_LR),
                           loss_kwargs=dict(LOSS_KW, ot_backend=backend))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms, outs = [], []
    hook = model.register_forward_hook(lambda mod, args, out: outs.append(_stage_hypos(out)))
    with contextlib.ExitStack() as stack:
        if dtype == F64:
            stack.enter_context(plain_warp())
        if moments:
            stack.enter_context(flax_moments())
        for i in range(1 + timed):
            t0 = time.perf_counter()
            scalars, _ = step(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                hook.remove()
                res = dict(scalars={k: float(v) for k, v in scalars.items()},
                           grads={k: p.grad.double().cpu().numpy()
                                  for k, p in model.named_parameters()})
                if hypos:
                    res["hypos"] = [h.cpu().numpy() for h in outs[0]]
    res.update(ms=ms, peak=torch.cuda.max_memory_allocated(dev) - base)
    del model, step, b
    torch.cuda.empty_cache()
    return res


def k23_on_band(dev, n, seed, stages=STAGES, batch=BATCH):
    """K2 and K3 on the last of n bands of a train step's four stages
    (`stages`' H, W, C and D, 4 sources; row0 = (n - 1) rows, the sources
    whole), each view's coordinates from plane_sweep_coords with that
    offset: K2 against warp_plain bitwise, K3 against scatter_grad_plain at
    phase 7's tolerance.  Returns K2's and K3's largest |kernel - plain|.
    Called after the path's counts were read."""
    err2 = err3 = 0.0
    for si, (h, w, c, d, _) in enumerate(stages):
        rows = h // n
        row0 = (n - 1) * rows
        inp = stage_inputs(seed + si, h, w, c, d, nsrc=NVIEWS - 1, batch=batch)
        ref_proj = t(inp["ref_proj"], dev)
        hypo = t(inp["hypo"][:, :, row0:], dev)
        rng = np.random.default_rng(seed + 10 + si)
        for v in range(NVIEWS - 1):
            x, y = plane_sweep_coords(t(inp["src_projs"][v], dev), ref_proj, hypo, row0)
            src = t(inp["src"][v], dev)
            cot = t(rng.normal(size=(batch, d, rows, w, c)), dev)
            got = warp_vjp.warp_gather(src, x, y)
            want = warp_vjp.warp_plain(src, x, y)
            dsrc = warp_vjp.scatter_grad(cot, x, y, src.shape)
            dwant = warp_vjp.scatter_grad_plain(cot, x, y, src.shape)
            torch.cuda.synchronize()
            if got.shape != (batch, d, rows, w, c) or dsrc.shape != src.shape:
                raise AssertionError(f"band {h}x{w}: K2 {tuple(got.shape)}, "
                                     f"K3 {tuple(dsrc.shape)}")
            if not (torch.isfinite(got).all() and torch.isfinite(dsrc).all()):
                raise AssertionError(f"band {h}x{w} view {v}: non-finite K2/K3 output")
            if not torch.equal(got, want):
                raise AssertionError(f"band {h}x{w} view {v}: K2 is not plain's bits, "
                                     f"max|d| {(got - want).abs().max().item():.3e}")
            torch.testing.assert_close(dsrc, dwant, rtol=K3_RTOL, atol=K3_ATOL)
            err2 = max(err2, (got - want).abs().max().item())
            err3 = max(err3, (dsrc - dwant).abs().max().item())
            del x, y, src, cot, got, want, dsrc, dwant
    torch.cuda.empty_cache()
    return err2, err3


def k45_on_band(dev, n, seed, stages=STAGES, batch=BATCH):
    """K4 and K5 at the pixels of one of n bands of each of `stages` against
    their plain versions (phase 12's tolerances): their largest |d|."""
    err4 = err5 = 0.0
    for si, (h, w, _, d, _) in enumerate(stages):
        e4, e5, *_ = k45_vs_plain(*ot_inputs(seed + si, h // n, w, d, dev, b=batch))
        err4, err5 = max(err4, e4), max(err5, e5)
    torch.cuda.empty_cache()
    return err4, err5


def _check_spatial_grads(got, exact, ref, ref_exact, one, what):
    """Each float32 gradient of a spatial run (`got`) against one process's
    float32 step with the same BatchNorm arithmetic (`ref`, flax_moments),
    each measured by its distance from a float64 step: e_sp, the relative L2
    distance from its split's float64 spatial step (`exact`), at most
    F32_NOISE_RATIO times e_ref (or 1e-4), that of `ref` from one process's
    float64 step (`ref_exact`), and the two within 1.5x their summed noise
    (or 1e-4), check_grads' rule; under GRAD_NOISE, at atol GRAD_NOISE; and
    the median of e_sp at most F32_MEDIAN_RATIO times e_ref's.  Each
    float32 step is held to a float64 step of its own split because a
    near-tied argmax moves a later stage's window at a pixel between any
    two steps that round differently, which moves every gradient upstream
    of that stage by the pixel's share.  `one`, one process's step through
    cuDNN's BatchNorm, is measured alongside.  Returns the worst (e_sp,
    key), (e_ref, key), (e_sp / max(e_ref, 1e-4), "key: e_sp / e_ref"),
    (relative L2 between the two, key) and (e_one, key), and the medians of
    e_sp, e_ref and e_one."""
    worst = {k: (0.0, "") for k in ("sp", "ref", "ratio", "rel", "one")}
    es, bad = {"sp": [], "ref": [], "one": []}, []
    for key, g_e in ref_exact.items():
        g_s, g_r = got[key], ref[key]
        if np.linalg.norm(g_e) < GRAD_NOISE:  # zero in exact arithmetic
            np.testing.assert_allclose(g_s, g_r, atol=GRAD_NOISE, err_msg=f"{what} {key}")
            continue
        e = dict(sp=relative_l2(g_s, exact[key]), ref=relative_l2(g_r, g_e),
                 one=relative_l2(one[key], g_e), rel=relative_l2(g_s, g_r))
        e["ratio"] = e["sp"] / max(e["ref"], 1e-4)
        if (e["sp"] > max(1e-4, F32_NOISE_RATIO * e["ref"])
                or e["rel"] > max(1e-4, 1.5 * (e["sp"] + e["ref"]))):
            bad.append(f"{key}: from float64, spatial {e['sp']:.2e}, one process "
                       f"{e['ref']:.2e}; between them {e['rel']:.2e}")
        for k in es:
            es[k].append(e[k])
        for k, v in e.items():
            if v > worst[k][0]:
                worst[k] = (v, key if k != "ratio" else
                            f"{key}: {e['sp']:.2e} / {e['ref']:.2e}")
    medians = {k: float(np.median(v)) for k, v in es.items()}
    if medians["sp"] > F32_MEDIAN_RATIO * medians["ref"]:
        bad.append(f"median from float64, spatial {medians['sp']:.2e}, one process "
                   f"{medians['ref']:.2e}")
    if bad:
        raise AssertionError(f"{what}: {len(bad)} gradients: " + "; ".join(bad[:6]))
    return worst, medians


def _check_scalars(got, want, dtype, what, window_rtol=WINDOW_RTOL):
    """A run's scalars against one process's: float64 at rtol 1e-6; float32
    at 1e-5, window_rtol for WINDOW_SCALARS, the pixel fractions at atol
    PIXEL_ATOL more; bf16 the loss at BF16_LOSS_RTOL and each stage loss at
    BF16_STAGE_RTOL.  Returns the worst relative difference and its key, and
    the keys that took the pixel fractions' atol."""
    flips, worst, bad = set(), (0.0, ""), []
    for key, v in want.items():
        if dtype == BF16 and key != "loss" and not key.endswith(("_d_loss", "_c_loss")):
            continue
        diff = abs(got[key] - v)
        if dtype == BF16:
            rtol = BF16_LOSS_RTOL if key == "loss" else BF16_STAGE_RTOL
        else:
            rtol = 1e-6 if dtype == F64 else window_rtol if key in WINDOW_SCALARS else 1e-5
        if diff > rtol * abs(v) + 1e-7:
            # a pixel fraction: a value within float32 rounding of its
            # threshold lands on either side
            if not key.startswith(PIXEL_FRACTIONS) or diff > rtol * abs(v) + PIXEL_ATOL:
                bad.append(f"{key}: {got[key]} vs one process {v}")
            flips.add(key)
        worst = max(worst, (diff / max(abs(v), 1e-30), key))
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(bad))
    return worst, flips


def _stage_hypos(out):
    """Each stage's hypotheses (B, D, H, W) of a forward's outputs."""
    return [out[f"stage{s}"]["hypo_depth"].detach() for s in range(1, 5)]


def _moved_windows(hypos, exact):
    """Pixels a stage whose hypothesis window differs (rtol 1e-5) from the
    float64 step's."""
    return [int((~np.all(np.isclose(h, e, rtol=1e-5), axis=1)).sum())
            for h, e in zip(hypos, exact)]


def _f32_grads_sane(got, exact, ref, ref_exact, what):
    """Phase 24's float32 gradients (`got`; `exact` its split's float64
    step; `ref` one process's float32 step with the ranks' BatchNorm
    arithmetic, `ref_exact` one process's float64 step): every tensor
    finite, and the median over the tensors of their relative L2 distance
    from float64 within F32_NOISE_RATIO times one process's.  Returns the
    worst (e_sp, key), (e_ref, key), and both medians."""
    e_sp, e_ref = {}, {}
    for key, g_e in ref_exact.items():
        if not np.isfinite(got[key]).all():
            raise AssertionError(f"{what} {key}: non-finite gradient")
        if np.linalg.norm(g_e) >= GRAD_NOISE:
            e_sp[key], e_ref[key] = relative_l2(got[key], exact[key]), relative_l2(ref[key], g_e)
    worst = max((v, k) for k, v in e_sp.items()), max((v, k) for k, v in e_ref.items())
    medians = float(np.median(list(e_sp.values()))), float(np.median(list(e_ref.values())))
    if medians[0] > F32_NOISE_RATIO * medians[1]:
        raise AssertionError(f"{what}: gradients' median relative L2 from float64 "
                             f"{medians[0]:.2e}, one process's {medians[1]:.2e}")
    return worst, medians


def _f64_grads_close(got, want, what):
    """Each float64 gradient within F64_GRAD_RTOL of one process's float64
    step (zero ones at atol 1e-10): the worst relative L2 and its key."""
    worst = (0.0, "")
    for key, g in want.items():
        if np.linalg.norm(g) < GRAD_NOISE:  # zero in exact arithmetic
            np.testing.assert_allclose(got[key], g, atol=1e-10, err_msg=f"{what} {key}")
            continue
        worst = max(worst, (relative_l2(got[key], g), key))
    if worst[0] > F64_GRAD_RTOL:
        raise AssertionError(f"{what} {worst[1]}: relative L2 {worst[0]:.2e} from one "
                             f"process's float64 step")
    return worst


def _bf16_grads_median(got, exact, one, one_exact, what):
    """bf16: every gradient finite, and the median over the tensors of the
    relative L2 distance from the split's float64 step at most
    BF16_MEDIAN_RATIO times one process's bf16 step's from its float64 one.
    Returns both medians."""
    e_sp, e_one = [], []
    for key, g_e in one_exact.items():
        if not np.isfinite(got[key]).all():
            raise AssertionError(f"{what} {key}: non-finite gradient")
        if np.linalg.norm(g_e) >= GRAD_NOISE:
            e_sp.append(relative_l2(got[key], exact[key]))
            e_one.append(relative_l2(one[key], g_e))
    medians = float(np.median(e_sp)), float(np.median(e_one))
    if medians[0] > BF16_MEDIAN_RATIO * medians[1]:
        raise AssertionError(f"{what}: median relative L2 from float64 {medians[0]:.2e}, one "
                             f"process's {medians[1]:.2e}")
    return medians


def phase23_spatial_train(dev, tmp, root, card):
    """The spatial train step as gloo ranks on the one card against one
    process's steps on the card, (a)-(c).  Returns the K1-K5 launches over
    the ranks of every run ((c)'s K1 apart) and the band errors of K2-K5."""
    import pickle
    import socket

    from mvster_tpu_torch.train.loop import device_batch

    t0 = time.perf_counter()
    state = _spatial_train_state()
    batches = _spatial_train_batches(root)
    single = {}
    for res_, backend, dtype, moments in SINGLE_RUNS:
        key = f"{res_}_{_kind(backend, dtype)}" + ("_m" if moments else "")
        single[key] = _single_train_step(
            state, batches[res_], backend, dev, dtype, moments=moments,
            timed=SPATIAL_TIMED if key == "raw_pallas" else 0)
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    with open(os.path.join(tmp, "spatial_train_inputs.pkl"), "wb") as f:
        pickle.dump(dict(batches, state=state, port=ports[1]), f)
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]))
    env.pop("LOCAL_RANK", None)
    t1 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "chip_smoke", SPATIAL_TRAIN_RANK, tmp],
                              cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        if p.returncode:
            raise AssertionError(f"spatial train rank {r} exited {p.returncode}:\n"
                                 f"{logs[r][-3000:]}")
    ranks_s = time.perf_counter() - t1
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"spatial_train_rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))

    totals = dict(K1=0, K2=0, K3=0, K4=0, K5=0)
    for name, data, n, b, backend, dtype in TRAIN_RUNS:
        parts = [ranks[r][name] for r in range(data * n)]
        per = 4 if backend == "pallas" else 0
        k23 = 0 if dtype == F64 else 4 * (NVIEWS - 1)
        want = dict(K1=0, K2=k23, K3=k23, K4=per, K5=per)
        res_, kind = name[:3], _kind(backend, dtype)
        h, w = (H, W) if res_ == "mid" else (RAW_H, RAW_W)
        for r, part in enumerate(parts):
            if (part["data_row"], part["band"]) != (r // n, r % n) or part["launches"] != want:
                raise AssertionError(f"{name} rank {r}: data row {part['data_row']}, band "
                                     f"{part['band']}, launches {part['launches']}, "
                                     f"expected {want}")
            if part["depth_shape"] != (b // data, h // n, w) or not part["finite"]:
                raise AssertionError(f"{name} rank {r}: images {part['depth_shape']}, "
                                     f"finite {part['finite']}")
            for k in totals:
                totals[k] += part["launches"][k]
            # parameters and running statistics bitwise equal across the ranks
            for key, v in parts[0]["after"].items():
                if not np.array_equal(part["after"][key], v):
                    raise AssertionError(f"{name}: rank {r}'s {key} differs from rank 0's")
            if part["scalars"] != parts[0]["scalars"]:
                raise AssertionError(f"{name}: rank {r}'s scalars differ from rank 0's")
        one = single[f"{res_}_{kind}"]
        worst_scalar, flips = _check_scalars(parts[0]["scalars"], one["scalars"], dtype, name)
        dtype_name = {F64: "float64, plain warp", BF16: "bfloat16 compute"}.get(dtype, "float32")
        head = (f"[23{'a' if res_ == 'mid' else 'b'} spatial train] {name}: dtu_default() "
                f"(mono on) at {h}x{w}, {NVIEWS} views, batch {b} as data {data} x spatial "
                f"{n} gloo ranks on the one card (bands of {h // n} rows), --ot_backend "
                f"{backend}, {dtype_name}, one SGD step (lr {DDP_LR}) vs one process's step "
                f"on the card: loss {parts[0]['scalars']['loss']:.6f} vs "
                f"{one['scalars']['loss']:.6f}, worst scalar rel diff {worst_scalar[0]:.2e} "
                f"({worst_scalar[1]}; ")
        tail = (f"; parameters and running statistics bitwise equal across the ranks; "
                f"launches a rank {parts[0]['launches']}; peak a rank "
                + " / ".join(f"{p['peak'] / 2**20:.1f}" for p in parts)
                + f" MiB vs one process {one['peak'] / 2**20:.1f} MiB; first step ms (host "
                f"clock) " + " / ".join(f"{p['first_ms']:.1f}" for p in parts)
                + f" vs one process {one['ms'][0]:.1f} | {card}")
        exact = ranks[0][name[:name.rindex("_")] + "_f64"]["grads"]
        if dtype == F64:
            worst = _f64_grads_close(parts[0]["grads"], one["grads"], name)
            log(head + f"rtol 1e-6); every gradient within relative L2 {worst[0]:.2e} "
                f"({worst[1]}; <= {F64_GRAD_RTOL}) of one process's float64 step" + tail)
        elif dtype == BF16:
            medians = _bf16_grads_median(parts[0]["grads"], exact, one["grads"],
                                         single[f"{res_}_f64"]["grads"], name)
            log(head + f"rtol {BF16_LOSS_RTOL} for the loss, {BF16_STAGE_RTOL} for each "
                f"stage's); gradients finite, their median relative L2 from their float64 "
                f"step {medians[0]:.2e}, one process's {medians[1]:.2e} (<= "
                f"{BF16_MEDIAN_RATIO}x)" + tail)
        else:
            worst, medians = _check_spatial_grads(
                parts[0]["grads"], exact, single[f"{res_}_{backend}_m"]["grads"],
                single[f"{res_}_f64"]["grads"], one["grads"], name)
            log(head + f"rtol 1e-5, {WINDOW_RTOL} for {', '.join(WINDOW_SCALARS)}; the "
                f"pixel fractions atol {PIXEL_ATOL} more, taken by {sorted(flips) or 'none'}); "
                f"gradients' relative L2 from their float64 step: spatial worst "
                f"{worst['sp'][0]:.2e} ({worst['sp'][1]}), median {medians['sp']:.2e}; one "
                f"process with the ranks' BatchNorm arithmetic worst {worst['ref'][0]:.2e} "
                f"({worst['ref'][1]}), median {medians['ref']:.2e}; spatial / that worst "
                f"{worst['ratio'][0]:.2f} ({worst['ratio'][1]}; <= {F32_NOISE_RATIO}), median "
                f"{medians['sp'] / medians['ref']:.2f} (<= {F32_MEDIAN_RATIO}); "
                f"between them worst {worst['rel'][0]:.2e} ({worst['rel'][1]}; <= 1.5x the "
                f"summed noise); one process through cuDNN's BatchNorm worst "
                f"{worst['one'][0]:.2e} ({worst['one'][1]}), median {medians['one']:.2e}"
                + tail)

    raw = [ranks[r]["raw_s2_pallas"] for r in range(2)]
    raw_one = single["raw_pallas"]
    gib = 2.0 ** 30
    log(f"[23b spatial train raw] {RAW_H}x{RAW_W}, {NVIEWS} views, batch 1, --ot_backend "
        f"pallas, spatial 2 (bands of {RAW_H // 2} rows): peak a rank "
        + " / ".join(f"{p['peak'] / gib:.3f}" for p in raw)
        + f" GiB vs one process's step {raw_one['peak'] / gib:.3f} GiB (predicted "
        f"{RAW_PEAK_GUESS_GIB[1]} and {RAW_PEAK_GUESS_GIB[0]}); ms a step (host clock; gloo "
        f"stages every exchange through the host: not a scaling number) "
        + "; ".join(f"rank {r} {p['first_ms']:.1f} first, "
                    + " / ".join(f"{m:.1f}" for m in p["ms"]) for r, p in enumerate(raw))
        + f"; one process {raw_one['ms'][0]:.1f} first, "
        + " / ".join(f"{m:.1f}" for m in raw_one["ms"][1:]) + f" | {card}")

    # (c) the weights after SERVED_RUN's step, on one process, by the comparator
    served = [ranks[r][SERVED_RUN]["serve"] for r in range(2)]
    model = MVS4Net(MVS4NetConfig.dtu_default())
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in ranks[0][SERVED_RUN]["after"].items()}, strict=True)
    model.to(dev).eval()
    mid = device_batch(batches["mid"], dev)
    with torch.inference_mode():
        want = to_numpy_tree(model(mid["imgs"][:1], {k: v[:1] for k, v in
                                                      mid["proj_matrices"].items()},
                                   mid["depth_values"][:1]))
    del model, mid
    torch.cuda.empty_cache()
    for r, part in enumerate(served):
        if part["launches"] != dict(K1=4, K2=0, K3=0, K4=0, K5=0):
            raise AssertionError(f"(c) rank {r}: launches {part['launches']}")
    got = dict(served[0]["gathered"], depth=served[0]["gathered"]["stage4"]["depth"])
    assert_stage_close(want, got)
    worst = max(np.abs(got[f"stage{s}"]["attn_weight"] - want[f"stage{s}"]["attn_weight"]).max()
                for s in range(1, 5))

    # K2-K5 on the bands of both resolutions' runs
    mid_err = (*k23_on_band(dev, 2, seed=230), *k45_on_band(dev, 2, seed=240))
    raw_err = (*k23_on_band(dev, 2, seed=250, stages=RAW_STAGES, batch=1),
               *k45_on_band(dev, 2, seed=260, stages=RAW_STAGES, batch=1))
    log(f"[23c serve trained] {SERVED_RUN}'s weights after its step through "
        f"make_spatial_infer_step on 2 ranks (4 K1 launches a rank): matches one process's "
        f"card forward by the stage comparator (attention max|d| {worst:.3e}) | on the last "
        f"of 2 bands (row0 = half the stage's rows, whole sources, 4 sources), the DTU-mid "
        f"stages at batch {BATCH} and the raw 1152x1600 stages at batch 1: K2 vs plain "
        f"bitwise (max|d| {mid_err[0]:.3e} / {raw_err[0]:.3e}), K3 vs plain max|d| "
        f"{mid_err[1]:.3e} / {raw_err[1]:.3e} (rtol {K3_RTOL}, atol {K3_ATOL}); K4/K5 at a "
        f"band's pixels vs plain max|d| {mid_err[2]:.3e} / {raw_err[2]:.3e} and "
        f"{mid_err[3]:.3e} / {raw_err[3]:.3e} (phase 12's tolerances)")
    log(f"[23] {time.perf_counter() - t0:.1f} s ({ranks_s:.1f} s for the ranks, 4 processes "
        f"started once); launches over the ranks of every run {totals}")
    return totals, served[0]["launches"]["K1"] + served[1]["launches"]["K1"], tuple(
        max(a, b) for a, b in zip(mid_err, raw_err))


SPATIAL_VARIANT_RANK = "--spatial-variant-rank"
# phase 24: the variants whose image-row sharding takes more than row-local
# layers, and those also run in 4 bands, where a halo (PDAM's 7x7x7 gate at
# Reg2d's deepest level: 2 rows a band at stage 1), a pool (CAM, DCAM) or a
# tap (DCN) reaches past the neighbouring band
VARIANT_SPAN4 = ("cam", "dcam", "pdam", "dcn")
VARIANT_SEED = 240
# (a) float64 (K1's and K7's plain versions) on the bands against one process's:
# every stage's attention within this (measured on an H100 at DTU-mid:
# 3.3e-12), besides the stage comparator
F64_ATTN_ATOL = 1e-9
# (a) float32 (K1): the stage comparator does not hold two float32 forwards
# that round differently at these widths, one process's against its own
# float64 forward included (measured: CAM 1935 stage-4 attention values
# past its atol; DCN's moved windows leave 71.8% of stage 2 to compare, its
# floor 90%), since CAM's and DCAM's pools couple every pixel and a moved
# window reaches past the comparator's 36 pixels.  So float32 is held by
# what a moved window leaves alone: each stage's hypothesis windows agree
# with one process's float32 forward at F32_AGREE of the pixels (measured:
# 99.80% at worst), and the final depth of each stage at F32_AGREE of the
# pixels where one process's top two probabilities differ by more than
# 0.05 (the comparator's decisive pixels)
F32_AGREE = 0.99
# (b) the float64 steps hold every scalar and gradient (within 1e-6 and
# 1e-7 of one process's).  In float32 a near-tied argmax moves a later
# stage's hypothesis window at some pixels between a step and its float64
# one, one process's as much as the bands' (measured on an H100 at
# DTU-mid: Reg3d's one process 16, 1136 and 13230 pixels at stages 2-4),
# and a moved window moves that stage's loss and every gradient it reaches
# by more than rounding does (PAM's stage-2 tensors 4.5e-2 to 1.0e-1 from
# float64, one process's 4e-3 to 7e-3); a band's convs also round another
# way than the whole image's (PDAM's stage-1 regulariser, which no window
# reaches, 1.1e-2 from float64 against one process's 6e-5), and ASFF's
# float32 step lies far from float64 in one process too (a median of
# 8.1e-2 over the tensors; 1.28 at `asff.3.weight_level_1.bn.bias` on the
# bands).  So phase 23's per-tensor rule does not hold here: the float32
# scalars downstream of a window (WINDOW_SCALARS) are held at ten times
# phase 23's rtol (measured: Reg3d's s3_c_loss 1.1e-4 apart, PAM's
# s2_c_loss 8.4e-5), and the gradients by their median distance from
# float64, within F32_NOISE_RATIO times one process's
VARIANT_WINDOW_RTOL = 1e-3


def _variant_state(name):
    """phase 4's kind of seeded weights of dtu_default() with the mono branch
    on and the variant's override (the train runs' weights)."""
    return build_model(VARIANT_SEED, mono=True, **BAND_VARIANTS[name]).state_dict()


def _serve_inputs(sample, dtype):
    imgs, projs, dv = model_inputs(sample, "cpu")  # the step moves the band's rows alone
    return imgs.to(dtype), {k: v.to(dtype) for k, v in projs.items()}, dv.to(dtype)


def _band_serve(name, n, sample, dev, rank):
    """One rank's spatial-n serve of a variant through make_spatial_infer_step:
    float32 with every count at 0 just before (its launches, and its peak
    memory above what was allocated before the model), then float64 with the
    plain cost volume; (rank 0) each forward's stage outputs (caught by a
    hook on the model), gathered."""
    from mvster_tpu_torch.dist import spatial

    groups = spatial.make_2d_groups(1, n)
    res = dict(band=groups.band)
    for dtype in (torch.float32, F64):
        base = torch.cuda.memory_allocated(dev)
        model = build_model(VARIANT_SEED, **BAND_VARIANTS[name]).to(dev, dtype)
        step = spatial.make_spatial_infer_step(model, groups)
        outs = []
        hook = model.register_forward_hook(lambda mod, args, out: outs.append(out))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        try:
            with plain_eval() if dtype == F64 else contextlib.nullcontext():
                step(*_serve_inputs(sample, dtype))
            torch.cuda.synchronize()
        finally:
            hook.remove()
        if dtype == torch.float32:
            res.update(launches=dict(_launch_counts(), K7=deform_conv.deform_conv.launches),
                       peak=torch.cuda.max_memory_allocated(dev) - base)
        (out,) = outs
        gathered = {f"stage{s}": {k: spatial.gather_rows(out[f"stage{s}"][k], groups).cpu()
                                  .numpy() for k in STAGE_KEYS} for s in range(1, 5)}
        if rank == 0:
            res["f64" if dtype == F64 else "f32"] = gathered
        del model, step, out, outs
        torch.cuda.empty_cache()
    return res


def _float32_agreement(ref, out, sample, what):
    """Phase 24 (a)'s float32 rule (F32_AGREE): per stage, the share of
    pixels whose hypothesis window agrees with one process's (rtol 1e-5)
    and the share of one process's decisive pixels whose depth agrees (the
    comparator's rtol 1e-3, atol 1e-2); every value finite and stage 1's
    depth inside [dmin, dmax].  Returns the (window, depth) shares."""
    dmin, dmax = sample["depth_values"][0, 0], sample["depth_values"][0, -1]
    d1 = out["stage1"]["depth"]
    if d1.min() < dmin * (1 - 1e-6) or d1.max() > dmax * (1 + 1e-6):
        raise AssertionError(f"{what}: stage-1 depth [{d1.min()}, {d1.max()}] outside "
                             f"[{dmin}, {dmax}]")
    shares = []
    for s in range(1, 5):
        r, o = ref[f"stage{s}"], out[f"stage{s}"]
        if not all(np.isfinite(v).all() for v in o.values()):
            raise AssertionError(f"{what} stage{s}: non-finite outputs")
        agree = np.all(np.isclose(o["hypo_depth"], r["hypo_depth"], rtol=1e-5), axis=1).mean()
        top2 = np.sort(r["attn_weight"], axis=1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 0.05
        same = np.isclose(o["depth"], r["depth"], rtol=1e-3, atol=1e-2)[decisive].mean()
        if agree < F32_AGREE or same < F32_AGREE:
            raise AssertionError(f"{what} stage{s}: windows agree at {agree:.4%}, decisive "
                                 f"depths at {same:.4%} (at least {F32_AGREE:.0%})")
        shares.append((float(agree), float(same)))
    return shares


def _band_train(name, dtype, batch, dev, rank):
    """One rank's spatial-2 SGD step of a variant: float64 (plain warp, xla)
    or float32 (--ot_backend pallas), with every count at 0 just before;
    scalars, a digest of the parameters and running statistics after it,
    and (rank 0) the gradients."""
    import hashlib

    from mvster_tpu_torch.dist import spatial

    backend = "xla" if dtype == F64 else "pallas"
    groups = spatial.make_2d_groups(1, 2)
    model = _train_model(_variant_state(name), dtype, dev, **BAND_VARIANTS[name])
    step = spatial.make_spatial_train_step(
        model, torch.optim.SGD(model.parameters(), lr=DDP_LR), groups,
        loss_kwargs=dict(LOSS_KW, ot_backend=backend))
    outs = []
    hook = model.register_forward_hook(lambda mod, args, out: outs.append(_stage_hypos(out)))
    _reset_counts()
    try:
        with plain_warp() if dtype == F64 else contextlib.nullcontext():
            scalars, images = step(_take(batch, slice(None), dtype))
        torch.cuda.synchronize()
    finally:
        hook.remove()
    hypos = [spatial.gather_rows(h, groups).cpu().numpy() for h in outs[0]]
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.cpu().numpy().tobytes())
    res = dict(launches=dict(_launch_counts(), K7=deform_conv.deform_conv.launches),
               scalars={k: float(v) for k, v in scalars.items()}, after=digest.hexdigest(),
               finite=bool(all(torch.isfinite(v).all() for v in images.values())))
    if rank == 0:
        res["grads"] = {k: p.grad.double().cpu().numpy() for k, p in model.named_parameters()}
        res["hypos"] = hypos
    del model, step, images, outs
    torch.cuda.empty_cache()
    return res


def _variant_pair(name):
    """The pair of ranks (0-1 or 2-3) that runs a variant's spatial-2 runs."""
    return list(BAND_VARIANTS).index(name) % 2


def spatial_variant_rank(tmp):
    """Phase 24, one of four processes on the one card over gloo: the
    VARIANT_SPAN4 serves as spatial 4 in a world of 4, then, ranks 0-1 and
    2-3 each in a world of their own at the same time, every other
    variant's spatial-2 serve, float64 and float32 train steps (pair
    _variant_pair).  Results to <tmp>/spatial_variant_rank<r>.pkl."""
    import pickle

    import torch.distributed as dist

    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))  # as phase 23's ranks
    dev = torch.device("cuda", 0)
    with open(os.path.join(tmp, "spatial_variant_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank, _ = maybe_initialize_distributed(dev, backend="gloo")
    out = {"serve4": {name: _band_serve(name, 4, inputs["sample"], dev, rank)
                      for name in VARIANT_SPAN4}}
    dist.destroy_process_group()
    pair, local = divmod(rank, 2)
    os.environ.update(WORLD_SIZE="2", RANK=str(local), MASTER_PORT=str(inputs["ports"][pair]))
    maybe_initialize_distributed(dev, backend="gloo")
    names = [name for name in BAND_VARIANTS if _variant_pair(name) == pair]
    out["serve2"] = {name: _band_serve(name, 2, inputs["sample"], dev, local) for name in names}
    for dtype, kind in ((F64, "f64"), (None, "pallas")):
        out[kind] = {name: _band_train(name, dtype, inputs["mid"], dev, local)
                     for name in names}
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"spatial_variant_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def phase24_spatial_variants(dev, tmp, root, card):
    """Every variant of BAND_VARIANTS through both spatial steps as gloo
    ranks on the one card, against one process's card forward and steps,
    which run while the ranks do: (a) serve at DTU-mid as spatial 2 (and
    VARIANT_SPAN4 as spatial 4) by the stage comparator, K1 on the last
    band against plain; (b) the DTU-mid train cell as spatial 2, float64
    and float32 (pallas).  Returns the launches over the ranks of (a) and
    (b), and the band errors of K1 and K2-K5."""
    import pickle
    import socket

    t0 = time.perf_counter()
    sample = synthetic_sample(24, nviews=NVIEWS, h=H, w=W)
    mid = _mid_batch(root)
    ports = []
    for _ in range(3):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    with open(os.path.join(tmp, "spatial_variant_inputs.pkl"), "wb") as f:
        pickle.dump(dict(sample=sample, mid=mid, ports=ports[1:]), f)
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]))
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen([sys.executable, "-m", "chip_smoke", SPATIAL_VARIANT_RANK, tmp],
                              cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    try:
        # one process's references on the card while the ranks run
        single = {}
        for name, overrides in BAND_VARIANTS.items():
            outs = {}
            for dtype in (torch.float32, F64):
                base = torch.cuda.memory_allocated(dev)
                model = build_model(VARIANT_SEED, **overrides).to(dev, dtype)
                imgs, projs, dv = _serve_inputs(sample, dtype)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                with torch.inference_mode(), (
                        plain_eval() if dtype == F64 else contextlib.nullcontext()):
                    out = to_numpy_tree(model(imgs.to(dev), {k: v.to(dev) for k, v in
                                                             projs.items()}, dv.to(dev)))
                if dtype == torch.float32:
                    peak = torch.cuda.max_memory_allocated(dev) - base
                outs["f64" if dtype == F64 else "f32"] = {
                    f"stage{s}": {k: out[f"stage{s}"][k] for k in STAGE_KEYS}
                    for s in range(1, 5)}
                del model, out
            state = _variant_state(name)
            single[name] = dict(
                out=outs["f32"], out64=outs["f64"], peak=peak,
                f64=_single_train_step(state, mid, "xla", dev, F64, overrides=overrides,
                                       hypos=True),
                f32=_single_train_step(state, mid, "pallas", dev, moments=True,
                                       overrides=overrides, hypos=True))
        single_s = time.perf_counter() - t0
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        if p.returncode:
            raise AssertionError(f"spatial variant rank {r} exited {p.returncode}:\n"
                                 f"{logs[r][-3000:] if logs else ''}")
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"spatial_variant_rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    ranks_s = time.perf_counter() - t0

    serve_totals = dict(K1=0, K2=0, K3=0, K4=0, K5=0, K7=0)
    train_totals = dict(serve_totals)
    for name in BAND_VARIANTS:
        ref = single[name]
        parts = []
        k7 = 4 if BAND_VARIANTS[name].get("dcn") else 0  # a head each of 4, a rank
        first = 2 * _variant_pair(name)
        for key, members in (("serve2", range(first, first + 2)), ("serve4", range(4))):
            if name not in ranks[members[0]][key]:
                continue
            runs, n = [ranks[r][key][name] for r in members], len(members)
            for r, run in enumerate(runs):
                if run["band"] != r or run["launches"] != dict(K1=4, K2=0, K3=0, K4=0, K5=0,
                                                                K7=k7):
                    raise AssertionError(f"{name} spatial {n} rank {r}: band {run['band']}, "
                                         f"launches {run['launches']}")
                for k in serve_totals:
                    serve_totals[k] += run["launches"][k]
            band64 = dict(runs[0]["f64"], depth=runs[0]["f64"]["stage4"]["depth"])
            assert_stage_close(dict(ref["out64"], depth=ref["out64"]["stage4"]["depth"]),
                               band64)
            worst64 = max(np.abs(band64[f"stage{s}"]["attn_weight"]
                                 - ref["out64"][f"stage{s}"]["attn_weight"]).max()
                          for s in range(1, 5))
            if worst64 > F64_ATTN_ATOL:
                raise AssertionError(f"{name} spatial {n}: float64 attention max|d| {worst64}")
            agree = _float32_agreement(ref["out"], runs[0]["f32"], sample, f"{name} spatial {n}")
            parts.append(
                f"spatial {n}: float64 attention max|d| {worst64:.3e}; float32 windows agree "
                f"at {min(a for a, _ in agree):.4%} (worst stage), decisive depths at "
                f"{min(d for _, d in agree):.4%}; peak a rank "
                + " / ".join(f"{run['peak'] / 2**20:.1f}" for run in runs) + " MiB")
        log(f"[24a spatial serve] {name}: dtu_default(mono=False, {BAND_VARIANTS[name]}) at "
            f"{H}x{W}, {NVIEWS} views, batch 1, 4 K1 and {k7} K7 launches a rank; float64 (K1's and K7's "
            f"plain versions) matches one process's float64 card forward by the stage comparator and "
            f"within {F64_ATTN_ATOL}; " + " | ".join(parts)
            + f"; one process {ref['peak'] / 2**20:.1f} MiB | {card}")

    for name in BAND_VARIANTS:
        ref = single[name]
        pair = (2 * _variant_pair(name), 2 * _variant_pair(name) + 1)
        f64 = [ranks[r]["f64"][name] for r in pair]
        f32 = [ranks[r]["pallas"][name] for r in pair]
        k23, k7 = 4 * (NVIEWS - 1), 4 if BAND_VARIANTS[name].get("dcn") else 0
        for kind, runs, want in (("f64", f64, dict(K1=0, K2=0, K3=0, K4=0, K5=0, K7=0)),
                                 ("pallas", f32, dict(K1=0, K2=k23, K3=k23, K4=4, K5=4, K7=k7))):
            for r, run in enumerate(runs):
                if run["launches"] != want or not run["finite"]:
                    raise AssertionError(f"{name} {kind} rank {r}: launches "
                                         f"{run['launches']}, finite {run['finite']}")
                if run["after"] != runs[0]["after"] or run["scalars"] != runs[0]["scalars"]:
                    raise AssertionError(f"{name} {kind}: rank {r}'s parameters, running "
                                         f"statistics or scalars differ from rank 0's")
                for k in train_totals:
                    train_totals[k] += run["launches"][k]
        worst64 = _f64_grads_close(f64[0]["grads"], ref["f64"]["grads"], f"{name} f64")
        scalar64, _ = _check_scalars(f64[0]["scalars"], ref["f64"]["scalars"], F64,
                                     f"{name} f64")
        scalar32, flips = _check_scalars(f32[0]["scalars"], ref["f32"]["scalars"], None,
                                         f"{name} pallas", window_rtol=VARIANT_WINDOW_RTOL)
        moved = _moved_windows(f32[0]["hypos"], f64[0]["hypos"])
        moved_one = _moved_windows(ref["f32"]["hypos"], ref["f64"]["hypos"])
        (worst, worst_one), medians = _f32_grads_sane(
            f32[0]["grads"], f64[0]["grads"], ref["f32"]["grads"], ref["f64"]["grads"],
            f"{name} pallas")
        log(f"[24b spatial train] {name}: dtu_default(mono on, {BAND_VARIANTS[name]}) at "
            f"{H}x{W}, {NVIEWS} views, batch {BATCH} as spatial 2 (bands of {H // 2} rows), "
            f"one SGD step (lr {DDP_LR}); float64 (plain warp, xla): every gradient within "
            f"relative L2 {worst64[0]:.2e} ({worst64[1]}; <= {F64_GRAD_RTOL}) of one "
            f"process's float64 step, worst scalar rel diff {scalar64[0]:.2e}; float32 "
            f"--ot_backend pallas against one process's float32 step with the ranks' "
            f"BatchNorm arithmetic: loss {f32[0]['scalars']['loss']:.6f} vs "
            f"{ref['f32']['scalars']['loss']:.6f}, worst scalar rel diff {scalar32[0]:.2e} "
            f"({scalar32[1]}; rtol 1e-5, {VARIANT_WINDOW_RTOL} for {', '.join(WINDOW_SCALARS)}; "
            f"the pixel fractions atol {PIXEL_ATOL} more, taken by {sorted(flips) or 'none'}); "
            f"pixels a stage whose window moved from the float64 step: spatial {moved}, one "
            f"process {moved_one}; gradients from their float64 step: spatial worst "
            f"{worst[0]:.2e} ({worst[1]}), median {medians[0]:.2e}; one "
            f"process worst {worst_one[0]:.2e} ({worst_one[1]}), median {medians[1]:.2e} "
            f"(spatial median <= {F32_NOISE_RATIO}x); launches a rank "
            f"{f32[0]['launches']}; ranks bitwise equal | {card}")

    k1_err = max(k1_on_band(dev, H, W, 2, seed=241), k1_on_band(dev, H, W, 4, seed=245))
    band_err = (*k23_on_band(dev, 2, seed=250), *k45_on_band(dev, 2, seed=255))
    log(f"[24c kernels on a band] K1 on the last of 2 and of 4 bands of the DTU-mid stages "
        f"vs plain max|d| {k1_err:.3e} (atol=rtol={KERNEL_TOL}); K2 (bitwise) / K3 / K4 / K5 "
        f"on the last of 2 bands at batch {BATCH} vs plain max|d| "
        + " / ".join(f"{e:.3e}" for e in band_err))
    log(f"[24] {time.perf_counter() - t0:.1f} s ({single_s:.1f} s for one process's "
        f"references while the ranks ran, {ranks_s:.1f} s until the ranks were done; 4 "
        f"processes started once); launches over the ranks: serve {serve_totals}, train "
        f"{train_totals}")
    return serve_totals, train_totals, k1_err, band_err


def k6_shapes(h, w, stages=((8, 8), (8, 8), (4, 4), (4, 4)), b=BATCH):
    """Reg2d's seven planar convs at each stage of an h x w train step:
    (name, transposed, M, C, stride, padding, g's shape, x's shape) as K6
    takes them (a transposed conv's input is g, its output gradient x)."""
    out = []
    for s, (d, g) in enumerate(stages):
        hs, ws = h >> (3 - s), w >> (3 - s)
        lv = [(hs >> k, ws >> k) for k in range(4)]
        out.append((f"s{s + 1}.conv0", False, 8, g, 1, (1, 1), (b, 8, d, *lv[0]), (b, g, d, *lv[0])))
        for k, (name, tname) in enumerate((("conv1", "conv11"), ("conv3", "conv9"),
                                           ("conv5", "conv7"))):
            m, c = 16 << k, 8 << k
            gs, xs = (b, m, d, *lv[k + 1]), (b, c, d, *lv[k])
            out.append((f"s{s + 1}.{name}", False, m, c, 2, (1, 1), gs, xs))
            out.append((f"s{s + 1}.{tname}", True, m, c, 2, (1, 1), gs, xs))
    return out


# make_spatial_train_step's stage 4 at 512x640 in 2 bands: conv0 on a band
# of 256 rows with its two halo rows (no row padding), and conv11 (the
# transposed conv) on 128 rows and its halo row, before the crop
K6_BANDS = [("band.conv0", False, 8, 4, 1, (0, 1), (BATCH, 8, 4, 256, 640), (BATCH, 4, 4, 258, 640)),
            ("band.conv11", True, 16, 8, 2, (1, 1), (BATCH, 16, 4, 129, 320),
             (BATCH, 8, 4, 257, 640))]


def _k6_library(transposed, g, x, stride, padding, m, c):
    """cuDNN's weight gradient of the same conv (autograd's call)."""
    w = torch.empty(m, c, 1, 3, 3, device=g.device)
    s, p = (1, stride, stride), (0, *padding)
    if transposed:  # the conv's input g, its output gradient x
        op = tuple(x.shape[i] - ((g.shape[i] - 1) * stride - 2 * padding[i - 3] + 3)
                   for i in (3, 4))
        return torch.ops.aten.convolution_backward(
            x, g, w, None, s, p, (1, 1, 1), True, (0, *op), 1, [False, True, False])[1]
    return torch.ops.aten.convolution_backward(
        g, x, w, None, s, p, (1, 1, 1), False, (0, 0, 0), 1, [False, True, False])[1]


def phase25_k6(dev, card):
    """K6 at every planar conv of the DTU-mid and 576x768 train steps and
    on two band shapes: against its plain version (grouped as the kernel
    groups its partial sums) and, with cuDNN's weight gradient, against
    the plain version in float64, per leaf; times queued (K6, cuDNN) and
    back to back (plain), the bound.  Returns the step sums."""
    gen = torch.Generator(device=dev).manual_seed(25)
    lines, sums, worst, max_abs = [], {}, [], 0.0
    cells = [("dtu-mid", k6_shapes(H, W)), ("blendedmvs", k6_shapes(BLEND_H, BLEND_W)),
             ("band", K6_BANDS)]
    for cell, shapes in cells:
        tot = dict(k6=0.0, bound=0.0, plain=0.0, library=0.0)
        for name, transposed, m, c, stride, padding, gs, xs in shapes:
            g = torch.randn(gs, generator=gen, device=dev)
            x = torch.randn(xs, generator=gen, device=dev)
            nb = conv_wgrad.plan_blocks(gs, c, stride, dev)
            got = conv_wgrad.conv_wgrad(g, x, stride, padding)
            again = conv_wgrad.conv_wgrad(g, x, stride, padding)
            plain = conv_wgrad.conv_wgrad_plain(g, x, stride, padding, blocks=nb)
            lib = _k6_library(transposed, g, x, stride, padding, m, c)
            f64 = conv_wgrad.conv_wgrad_plain(g.double(), x.double(), stride, padding)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K6 {name}: two launches differ")
            ref = f64.norm().item()
            d_k6 = (got.double() - f64).norm().item() / ref
            d_lib = (lib.double() - f64).norm().item() / ref
            err = (got - plain).abs().max().item()
            max_abs = max(max_abs, err)
            d_plain = err / f64.abs().max().item()
            worst.append((d_k6 / d_lib, cell, name))
            k6_ms = queued_ms(lambda: conv_wgrad.conv_wgrad(g, x, stride, padding), 20)
            lib_ms = queued_ms(lambda: _k6_library(transposed, g, x, stride, padding, m, c), 5)
            plain_ms = cuda_ms(lambda: conv_wgrad.conv_wgrad_plain(g, x, stride, padding,
                                                                   blocks=nb), 3, warmup=1)
            k = gs[0] * gs[2] * gs[3] * gs[4]
            b_ms, b_by = bound(4 * (g.numel() + x.numel() + m * c * 9), 2 * m * c * 9 * k)
            for key, v in (("k6", k6_ms), ("bound", b_ms), ("plain", plain_ms),
                           ("library", lib_ms)):
                tot[key] += v
            lines.append(f"{cell} {name}{' (T)' if transposed else ''}: g {tuple(gs)} x "
                         f"{tuple(xs)} s{stride} pad {padding}: K6 {k6_ms:.4f} ms, bound "
                         f"{b_ms:.4f} ({b_by}), plain {plain_ms:.3f}, cuDNN {lib_ms:.3f}; "
                         f"|d| from f64 K6 {d_k6:.3e} cuDNN {d_lib:.3e}; K6-plain "
                         f"{d_plain:.2e}; {nb} blocks")
            del g, x, got, again, plain, lib, f64
        sums[cell] = tot
        log(f"[25 K6] {cell}: {len(shapes)} convs, K6 {tot['k6']:.3f} ms, bound "
            f"{tot['bound']:.4f}, plain {tot['plain']:.2f}, cuDNN {tot['library']:.2f} | {card}")
    for line in lines:
        log("  " + line)
    ratio, cell, name = max(worst)
    if ratio > 2.0:
        raise AssertionError(f"K6 {cell} {name}: {ratio:.2f}x cuDNN's distance from float64")
    log(f"[25 K6] the same bits twice at every shape; the widest K6 distance from float64 "
        f"is {ratio:.2f}x cuDNN's ({cell} {name})")
    return sums, max_abs


def k6_entry():
    """Phases 1, 2 and 25 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1 device] {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__}")
    _build.build()
    _build.load_library()
    log(f"[2 build] nvcc {_build.build_seconds} s")
    phase25_k6(torch.device("cuda"), card)
    return 0


def k7_heads(h=None, w=None):
    """(C, h, w) of FPN4's four heads at base 8 for an h x w view."""
    h, w = h or SERVE_H, w or SERVE_W
    return [(64, h // 8, w // 8), (32, h // 4, w // 4), (16, h // 2, w // 2), (8, h, w)]


def k7_work(n, c, h, w):
    """K7's bytes (the map, 27 offset and mask floats a pixel and the
    output, each once) and FLOPs (2 x 9C x C of contraction and 72 C of
    sampling a pixel) over n images of h x w."""
    pixels = n * h * w
    return pixels * (8 * c + 4 * 27), pixels * (18 * c * c + 72 * c)


def _k7_ptxas():
    """ptxas's registers and spills of each K7 instance, from nvcc.log."""
    log = (_build.library_path().parent / "nvcc.log").read_text()
    i = log.index("== deform_conv.cu")
    j = log.find("\n==", i + 5)
    out = []
    for line in log[i:j if j > 0 else None].splitlines():
        if "Compiling entry" in line and "deform_conv_kernelILi" in line:
            out.append("C=" + line.split("deform_conv_kernelILi")[1].split("E")[0] + ":")
        elif out and ("registers" in line or "spill" in line):
            out[-1] += " " + line.replace("ptxas info    : ", "").strip()
    return out


def phase26_k7(dev, card):
    """K7 at the four heads of a served view, three reaches of offsets:
    against its plain version, the same bits twice, timed beside its bound
    and the plain version.  Returns (per-reach sums, max |K7 - plain|)."""
    for line in _k7_ptxas():
        log("  ptxas " + line)
    gen = torch.Generator(device=dev).manual_seed(26)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sums, max_abs = {}, 0.0
    for reach, scale in K7_REACHES:
        tot = dict(k7=0.0, call=0.0, copy=0.0, bound=0.0, plain=0.0)
        for c, h, w in k7_heads():
            n = K7_VIEWS
            x = torch.randn(n, c, h, w, generator=gen, device=dev).relu()
            if scale is None:
                off = torch.randn(n, 18, h, w, generator=gen, device=dev)
            else:
                off = (torch.rand(n, 18, h, w, generator=gen, device=dev) * 2 - 1) * scale
            mask = torch.randn(n, 9, h, w, generator=gen, device=dev) * 2
            wt = torch.randn(c, c, 3, 3, generator=gen, device=dev) / (9 * c) ** 0.5
            with torch.inference_mode():
                got = deform_conv.deform_conv(x, off, mask, wt)
                again = deform_conv.deform_conv(x, off, mask, wt)
                plain = deform_conv.deform_conv_plain(x, off, mask, wt)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K7 C={c} {reach}: two launches differ")
                err = (got - plain).abs().max().item()
                limit = K7_TOL * (1 + plain.abs().max().item())
                if err > limit:
                    raise AssertionError(f"K7 C={c} {reach}: max|K7 - plain| {err:.3e} > {limit:.3e}")
                max_abs = max(max_abs, err)
                x_last = x.permute(0, 2, 3, 1).contiguous()
                out = torch.empty_like(got)

                def k7_alone():
                    rc = lib.mvster_deform_conv(x_last.data_ptr(), off.data_ptr(),
                                                mask.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                                n, c, h, w, h, 0, stream)
                    if rc:
                        raise AssertionError(f"mvster_deform_conv returned {rc}")

                k7_ms = queued_ms(k7_alone, 20)
                call_ms = queued_ms(lambda: deform_conv.deform_conv(x, off, mask, wt), 20)
                copy_ms = queued_ms(lambda: x.permute(0, 2, 3, 1).contiguous(), 20)
                plain_ms = cuda_ms(lambda: deform_conv.deform_conv_plain(x, off, mask, wt), 3, warmup=1)
            b_ms, b_by = bound(*k7_work(n, c, h, w))
            for key, v in (("k7", k7_ms), ("call", call_ms), ("copy", copy_ms),
                           ("bound", b_ms), ("plain", plain_ms)):
                tot[key] += v
            log(f"  [26 K7] {reach} C={c} {n}x{h}x{w}: K7 {k7_ms:.4f} ms, with its copy "
                f"{call_ms:.4f} (copy {copy_ms:.4f}), bound {b_ms:.4f} ({b_by}), plain "
                f"{plain_ms:.3f}; max|K7 - plain| {err:.2e}")
            del x, off, mask, wt, got, again, plain, x_last, out
            torch.cuda.empty_cache()
        sums[reach] = tot
        log(f"[26 K7] {reach}: a view's four heads K7 {tot['k7']:.4f} ms, with copies "
            f"{tot['call']:.4f}, bound {tot['bound']:.4f} ({100 * tot['bound'] / tot['k7']:.1f}% "
            f"of K7), plain {tot['plain']:.2f} | {card}")
    return sums, max_abs


def k7_entry():
    """Phases 1, 2 and 26 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[1 device] {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__}")
    _build.build()
    _build.load_library()
    log(f"[2 build] nvcc {_build.build_seconds} s")
    phase26_k7(torch.device("cuda"), card)
    return 0


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
    mid_out = out  # phase 22 holds the spatial step against it
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
    profile_forward(model, inputs, fwd_ms, card)
    k1_sums, k1_bounds = phase6_k1_times(stage_args, card)

    # 7-11: the training path; 12-15: the fused Sinkhorn loss and the
    # BlendedMVS fine-tune
    err2, err3, per_stage = phase7_kernels(dev)
    err4, err5, ot_stages = phase12_sinkhorn(dev)
    rates, sms, mhz = clock_rates()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        costs = math_costs(tmp)
        k2_launches, k3_launches, k6_launches, root, ckpt = phase8_train(dev, tmp, card)
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
        phase16_off_default(dev, card, rates, costs)
        # 17-19: the serving path from phase 8's checkpoint
        dtu_launches, dtu_err, serve = phase17_dtu_scan(dev, tmp, ckpt, card)
        phase18_fusion(dev, tmp, serve, card)
        tanks_launches, tanks_err = phase19_tanks(dev, tmp, ckpt, card)
        # 20: data parallel, from phase 8's tree
        ddp_launches = phase20_ddp_entry(dev, tmp, root, card)
        phase20_gloo_pair(dev, tmp, root, card)
        # 21: the model variants, from phase 8's tree and phase 17's scan
        variant_launches, k7_paths = phase21_variants(dev, tmp, root, ckpt, serve, card)
        # 22: image-row sharding, the vis dumps and the sg_cuts hook
        spatial_launches, spatial_err, vis_launches, vis_err, cut_launches = phase22(
            dev, tmp, root, ckpt, serve, model, mid_out, card)
        # 23: the image-row sharded train step, from phase 8's tree
        st_launches, st_k1, (st_err2, st_err3, st_err4, st_err5) = phase23_spatial_train(
            dev, tmp, root, card)
        # 24: every variant through both spatial steps, from phase 8's tree
        sv_serve, sv_train, sv_k1_err, (sv_err2, sv_err3, sv_err4, sv_err5) = (
            phase24_spatial_variants(dev, tmp, root, card))
    # 25: K6 at the train cells' planar convs
    k6_sums, k6_err = phase25_k6(dev, card)
    # 26: K7 at a served --dcn view's heads
    k7_sums, k7_err = phase26_k7(dev, card)

    print(card)
    print(json.dumps({"kernels": [
        dict(KERNEL, launches=main_path_launches,
             max_abs_err=max(*errs, dtu_err, tanks_err, spatial_err, sv_k1_err),
             ms=k1_sums["qk"],
             plain_ms=k1_sums["p"], bound_ms=k1_sums["b"], bound_by=k1_bounds[-1][1],
             library_ms=None, back_to_back_ms=k1_sums["k"], wrapper_ms=k1_sums["w"],
             launches_by_path={"serve": main_path_launches, "dtu_scan": dtu_launches,
                               "tanks": tanks_launches, "ddp_train": ddp_launches["K1"],
                               "variants": variant_launches["K1"],
                               "spatial_serve": spatial_launches,
                               "spatial_train_serve": st_k1,
                               "spatial_variants_serve": sv_serve["K1"]},
             max_abs_err_by_path={"serve": max(errs), "dtu_scan": dtu_err, "tanks": tanks_err,
                                  "spatial_serve": spatial_err,
                                  "spatial_variants_serve": sv_k1_err}),
        dict(K2, launches=k2_launches, max_abs_err=max(err2, vis_err, st_err2, sv_err2),
             ms=sums["qk2"],
             plain_ms=sums["p2"], bound_ms=sums["b2"], bound_by=by2,
             library_ms=sums["qgs_f"], back_to_back_ms=sums["k2"],
             launches_by_path={"train": k2_launches, "ddp_train": ddp_launches["K2"],
                              "variants": variant_launches["K2"], "vis_eta": vis_launches,
                              "sg_cuts": cut_launches["K2"], "spatial_train": st_launches["K2"],
                              "spatial_variants_train": sv_train["K2"]},
             max_abs_err_by_path={"train": err2, "vis_eta": vis_err, "spatial_train": st_err2,
                                  "spatial_variants_train": sv_err2}),
        dict(K3, launches=k3_launches, max_abs_err=max(err3, st_err3, sv_err3), ms=sums["qk3"],
             plain_ms=sums["p3"], bound_ms=sums["b3"], bound_by=by3,
             library_ms=sums["qgs_b"], back_to_back_ms=sums["k3"],
             launches_by_path={"train": k3_launches, "ddp_train": ddp_launches["K3"],
                              "variants": variant_launches["K3"],
                              "sg_cuts": cut_launches["K3"], "spatial_train": st_launches["K3"],
                              "spatial_variants_train": sv_train["K3"]},
             max_abs_err_by_path={"train": err3, "spatial_train": st_err3,
                                  "spatial_variants_train": sv_err3}),
        dict(K4, launches=ft_launches["K4"], max_abs_err=max(err4, st_err4, sv_err4),
             ms=ot_sums["qk4"],
             plain_ms=ot_sums["p4"], bound_ms=ot_sums["b4"], bound_by=by4,
             library_ms=None, back_to_back_ms=ot_sums["k4"],
             launches_by_path={"fine_tune": ft_launches["K4"], "ddp_train": ddp_launches["K4"],
                              "variants": variant_launches["K4"],
                              "sg_cuts": cut_launches["K4"], "spatial_train": st_launches["K4"],
                              "spatial_variants_train": sv_train["K4"]},
             max_abs_err_by_path={"train": err4, "spatial_train": st_err4,
                                  "spatial_variants_train": sv_err4}),
        dict(K5, launches=ft_launches["K5"], max_abs_err=max(err5, st_err5, sv_err5),
             ms=ot_sums["qk5"],
             plain_ms=ot_sums["p5"], bound_ms=ot_sums["b5"], bound_by=by5,
             library_ms=None, back_to_back_ms=ot_sums["k5"],
             launches_by_path={"fine_tune": ft_launches["K5"], "ddp_train": ddp_launches["K5"],
                              "variants": variant_launches["K5"],
                              "sg_cuts": cut_launches["K5"], "spatial_train": st_launches["K5"],
                              "spatial_variants_train": sv_train["K5"]},
             max_abs_err_by_path={"train": err5, "spatial_train": st_err5,
                                  "spatial_variants_train": sv_err5}),
        dict(K6, launches=k6_launches, max_abs_err=k6_err, ms=k6_sums["dtu-mid"]["k6"],
             plain_ms=k6_sums["dtu-mid"]["plain"], bound_ms=k6_sums["dtu-mid"]["bound"],
             library_ms=k6_sums["dtu-mid"]["library"],
             launches_by_path={"train": k6_launches}),
        dict(K7, launches=k7_paths["serve"], max_abs_err=k7_err, ms=k7_sums["normal1"]["k7"],
             plain_ms=k7_sums["normal1"]["plain"], bound_ms=k7_sums["normal1"]["bound"],
             library_ms=None, with_copy_ms=k7_sums["normal1"]["call"],
             launches_by_path={"serve": k7_paths["serve"], "train": k7_paths["train"],
                               "spatial_variants_serve": sv_serve["K7"],
                               "spatial_variants_train": sv_train["K7"]}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [K6_ENTRY]:
        sys.exit(k6_entry())
    if sys.argv[1:2] == [K7_ENTRY]:
        sys.exit(k7_entry())
    if sys.argv[1:2] == [DDP_ENTRY]:
        sys.exit(ddp_entry(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == [GLOO_RANK]:
        sys.exit(gloo_rank(sys.argv[2]))
    if sys.argv[1:2] == [SPATIAL_RANK]:
        sys.exit(spatial_rank(sys.argv[2]))
    if sys.argv[1:2] == [SPATIAL_TRAIN_RANK]:
        sys.exit(spatial_train_rank(sys.argv[2]))
    if sys.argv[1:2] == [SPATIAL_VARIANT_RANK]:
        sys.exit(spatial_variant_rank(sys.argv[2]))
    sys.exit(main())
