"""The yardstick: the H100's published peaks, the least work of each kernel
and the FLOPs of the plain reference.

Peaks (NVIDIA H100 SXM data sheet, dense): 67 TFLOP/s in float32 outside
the tensor cores (TF32 is off in the system), 3.35 TB/s of HBM3.  Its
float32 pipe starts one FFMA, FADD or FMUL a lane a clock and counts an
FFMA as two FLOPs, so it issues 33.5e12 instructions a second; the
special-function unit (MUFU: ex2, rcp) an eighth of that.

A kernel's least time is the larger of its bytes over the bandwidth and
its operations over the peak; its roofline share is that least time over
its measured device time.  The work is counted from the shapes of the
stage it serves, each input read once and each output written once, so it
is the same whatever implements it.  K1-K3 as chip_smoke.py counts them;
K4/K5 per pixel from the steps of the plain Sinkhorn (chip_smoke.ot_work),
with the cost of one accurate expf, logf and float32 division frozen at
what their SASS for sm_90a counted (6 float32-pipe + 1 MUFU, 15 + 0,
5 + 1), so the yardstick does not move with the toolkit or the card.
"""

from __future__ import annotations

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
F32_PIPE_PER_S = F32_FLOP_PER_S / 2
MUFU_PER_S = F32_PIPE_PER_S / 8
MATH_COSTS = {"exp": (6, 1), "log": (15, 0), "div": (5, 1)}


def stage_shapes(height, width, cfg):
    """[(h, w, c, d, g)] of the four stages: the FPN's channels 8b, 4b, 2b,
    b at strides 8, 4, 2, 1, the stage's hypotheses and groups."""
    b = cfg.fpn_base
    return [(height >> (3 - s), width >> (3 - s), (8 * b) >> s, cfg.ndepths[s],
             cfg.group_cor_dim[s]) for s in range(4)]


def bound_s(nbytes, ops):
    """The least seconds for nbytes of HBM traffic and ops float32 FLOPs."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


def k1_work(h, w, c, d, g, b, v):
    """K1 (fused warp + group correlation + view weighting) for one stage,
    v source views: (bytes, FLOPs).  Reads the reference and source maps,
    the hypotheses and rot/trans, writes the volume; per pixel, view and
    hypothesis ~30 operations for the coordinates and weights and 9 a
    channel for the four taps and the correlation."""
    nbytes = 4 * (b * h * w * c + v * b * h * w * c + b * d * h * w + v * b * 12
                  + b * d * h * w * g)
    return nbytes, b * h * w * v * d * (9 * c + 30)


def k2_k3_work(h, w, c, d, b):
    """K2 (warp gather) and K3 (its gradient scatter) for one source view of
    one stage: (bytes, K2 FLOPs, K3 FLOPs).  K2 reads the source and x, y
    and writes (B, D, H, W, C); 7 operations an output value and ~20 a
    coordinate.  K3 moves the same bytes the other way, 8 a value."""
    n = b * d * h * w
    nbytes = 4 * (b * h * w * c + 2 * n + n * c)
    return nbytes, n * (7 * c + 20), n * (8 * c + 20)


def ot_work(n, d, iters=10, costs=MATH_COSTS):
    """K4's and K5's least work for n pixels of d bins, each
    (float32-pipe instructions, MUFU instructions, bytes):
      K4: d logs and d divisions for the marginals and S; an iteration
          2 d^2 exp and 2 d log, 6 d^2 + 2 d adds; the loss d^2 exp and
          3 d^2 + d; reads d + 1 words and writes 1.
      K5: the replay as K4; the plan d^2 exp and 4 d^2 + 3 d; each of the
          iters steps of the reverse sweep a softmax over rows (d^2 exp, d^2
          divisions, 4 d^2 + d), each but the last one over columns too
          (the same, 4 d^2 - d); d divisions and d adds for dL/dpred; reads
          pred, gt_idx and g and writes dpred (2 d + 2 words)."""
    def total(explicit, n_exp, n_log, n_div):
        counts = ((n_exp, "exp"), (n_log, "log"), (n_div, "div"))
        pipe = explicit + sum(k * costs[op][0] for k, op in counts)
        mufu = sum(k * costs[op][1] for k, op in counts)
        return n * pipe, n * mufu

    sq, sweep = d * d, 2 * iters - 1
    replay = d + iters * (6 * sq + 2 * d)
    k4 = total(replay + 3 * sq + d, iters * 2 * sq + sq, d + iters * 2 * d, d)
    k5 = total(replay + 4 * sq + 3 * d + iters * (4 * sq + d) + (iters - 1) * (4 * sq - d) + d,
               iters * 2 * sq + sq + sweep * sq, d + iters * 2 * d, d + sweep * sq + d)
    return (*k4, 4 * n * (d + 2)), (*k5, 4 * n * (2 * d + 2))


def ot_bound_s(pipe, mufu, nbytes):
    """The least seconds for the instructions at the published issue rates
    and the bytes at 3.35 TB/s."""
    return max(pipe / F32_PIPE_PER_S, mufu / MUFU_PER_S, nbytes / HBM_BYTES_PER_S)


def least_seconds(kernel, shapes, batch, views, iters=10):
    """The least seconds of one unit of work (an eval forward for K1, a
    train step for K2-K5) of `kernel` over the stages `shapes`."""
    total = 0.0
    for h, w, c, d, g in shapes:
        if kernel == "k1":
            total += bound_s(*k1_work(h, w, c, d, g, batch, views - 1))
        elif kernel in ("k2", "k3"):
            nbytes, f2, f3 = k2_k3_work(h, w, c, d, batch)
            total += (views - 1) * bound_s(nbytes, f2 if kernel == "k2" else f3)
        else:
            k4, k5 = ot_work(batch * h * w, d, iters)
            total += ot_bound_s(*(k4 if kernel == "k4" else k5))
    return total


def reference_flops(ref, cfg, height, width, views, batch, train):
    """FLOPs of the plain reference's (the module `ref` at its cfg) eval
    forward, or of its train forward, loss and backward, at these shapes,
    counted by FlopCounterMode on the meta device (convolutions and matrix
    products; elementwise work is not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mvsbench.reference import losses
    from mvsbench.weights import seeded_state_dict

    meta = torch.device("meta")
    sd = {k: v.to(meta) for k, v in seeded_state_dict(
        ref.state_shapes(cfg), 0, "cpu").items()}
    params = [v.requires_grad_(train) for k, v in sd.items() if v.is_floating_point()]
    imgs = torch.empty(batch, views, height, width, 3, device=meta)
    projs = {f"stage{s}": torch.empty(batch, views, 2, 4, 4, device=meta)
             for s in range(1, 5)}
    dv = torch.empty(batch, 2, device=meta)
    with FlopCounterMode(display=False) as counter:
        outs, mono = ref.forward(sd, cfg, imgs, projs, dv, train=train)
        if train:
            gt = {k: torch.empty(batch, *o["depth"].shape[1:], device=meta)
                  for k, o in outs.items()}
            total, _ = losses.mvs4net_loss(outs, mono, gt, gt)
            torch.autograd.grad(total, [p for p in params if p.requires_grad],
                                allow_unused=True)
    return counter.get_total_flops()
