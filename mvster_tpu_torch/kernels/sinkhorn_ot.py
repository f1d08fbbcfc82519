"""The fused Sinkhorn OT depth loss: CUDA kernels K4/K5, their plain versions and the loss.

Counterpart of mvster_tpu.kernels.pallas_sinkhorn.  Per pixel, `iters`
log-domain Sinkhorn updates between the predicted depth-bin distribution
(D bins) and the one-hot GT bin, then the transport cost sum T * C:

  forward   `sinkhorn_fwd` (K4, csrc/sinkhorn_ot.cu mvster_sinkhorn_fwd),
            which replaces pallas_sinkhorn.py::_fwd_kernel
  backward  `sinkhorn_bwd` (K5, mvster_sinkhorn_bwd), which replaces
            pallas_sinkhorn.py::_bwd_kernel: it replays the forward and runs
            the hand-derived reverse sweep

A CPU tensor takes the plain versions, `sinkhorn_pixels_plain` and
`sinkhorn_pixels_bwd_plain` (the same steps in PyTorch; the backward is
written out, not autograd, so the tests can hold it against autograd); a
CUDA tensor launches the kernel or raises.  `sinkhorn_fwd.launches` and
`sinkhorn_bwd.launches` count kernel launches.  `plan_launch` decides, in
Python, how the kernels map threads to bins: D lanes a pixel, or one
thread a pixel above 32 bins and where that was measured faster.

Layouts: pred (B, D, N) float32, the model's attention (B, D, H, W) as it
lies with N = H * W; gt_idx (B, N) integer GT bins; per-pixel loss and its
cotangent (B, N); dL/dpred (B, D, N).  The autograd Function keeps only
pred and gt_idx for its backward, never the transport plan.
`sinkhorn_loss_fused` is the contract of the JAX package's
sinkhorn_loss_pallas: the masked-mean loss of discrete OT, differentiable
with respect to attn_weight.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from mvster_tpu_torch.dist.reduce import global_mean
from mvster_tpu_torch.kernels._build import check_tensor, load_library, raise_on_error

_LOG_EPS = math.log(1e-12)
_LOG_ONE = math.log(1.0 + 1e-12)
MAX_D = 64  # the most bins K4/K5 take (dtu_default uses 8, 8, 4, 4)
MAX_LANES = 32  # the most bins that run with a thread a bin
LANE_CAPACITIES = (1, 2, 4, 8, 16, 32)  # csrc/sinkhorn_ot.cu's instances, lanes
THREAD_CAPACITIES = (4, 8, 64)  # ... and one thread a pixel
DESIGNS = ("lanes", "thread")  # the C interface's design argument, 0 and 1
KERNELS = ("fwd", "bwd")  # K4, K5
THREADS = 256  # kThreads: K4's block with lanes, K5's largest
THREAD_FWD = 128  # kThreadFwd: K4's block with one thread a pixel
# Where one thread a pixel beat D lanes on the H100 (scripts/torch_sinkhorn_ab.py,
# 10 iterations, batch 2 at 64x80, 128x160, 256x320 and 512x640; PERF.md):
# {D: the B * N pixels from which it is taken}.  It won from 163,840 pixels
# on and lost at 40,960, except K4 at D = 5 (won at 40,960, lost at 10,240);
# FILL_PIXELS is half the card's resident threads (132 SMs x 2048 / 2).
FILL_PIXELS = 132 * 1024
THREAD_FROM = {"fwd": {3: FILL_PIXELS, 4: FILL_PIXELS, 5: 40_960, 6: FILL_PIXELS,
                       7: FILL_PIXELS, 8: FILL_PIXELS},
               "bwd": {3: FILL_PIXELS, 4: FILL_PIXELS, 5: FILL_PIXELS}}
SMEM_BYTES_MAX = 232_448  # dynamic shared memory one block may have (227 KB)
_SMEM_DEFAULT = 48 * 1024  # what a launch gets without raising its limit
_BLOCKS = (256, 128, 64, 32)  # K5's block sizes, largest first


def _scaled_cost(d, eps, device):
    """(S, C): S = |i - j| / eps and C = S * eps, (D, D) float32, as the
    TPU kernel computes them."""
    idx = torch.arange(d, device=device)
    scaled = (idx[:, None] - idx[None, :]).abs().float() / eps
    return scaled, scaled * eps


def _log_mu(gt_idx, d):
    """(B, D, N) log of the one-hot GT distribution (+1e-12 guard)."""
    rows = torch.arange(d, device=gt_idx.device).view(1, d, 1)
    one = torch.tensor(_LOG_ONE, dtype=torch.float32, device=gt_idx.device)
    eps = torch.tensor(_LOG_EPS, dtype=torch.float32, device=gt_idx.device)
    return torch.where(rows == gt_idx[:, None, :], one, eps)


def _iterate(s, log_mu, log_nu, u):
    """One Sinkhorn update (v from u, then u from v); s is S as (D, D, 1),
    u, v, log_mu, log_nu (B, D, N)."""
    e = s + u[:, :, None, :]  # (B, Di, Dj, N): S_ij + u_i
    m = e.amax(dim=1)
    v = log_mu - (torch.log(torch.exp(e - m[:, None]).sum(dim=1)) + m)
    e = s + v[:, None, :, :]  # S_ij + v_j
    m = e.amax(dim=2)
    u = log_nu - (torch.log(torch.exp(e - m[:, :, None]).sum(dim=2)) + m)
    return u, v


def _marginals(pred, gt_idx, eps):
    """S and C as (D, D, 1), log mu and log nu (B, D, N)."""
    d = pred.shape[1]
    scaled, cost = _scaled_cost(d, eps, pred.device)
    return (scaled[:, :, None], cost[:, :, None], _log_mu(gt_idx, d),
            torch.log(pred + 1e-12))


def sinkhorn_pixels_plain(pred: torch.Tensor, gt_idx: torch.Tensor, iters: int,
                          eps: float = 1.0) -> torch.Tensor:
    """Plain version of K4: pred (B, D, N), gt_idx (B, N) -> loss (B, N)."""
    s, cost, log_mu, log_nu = _marginals(pred, gt_idx, eps)
    u = torch.zeros_like(log_nu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u, v = _iterate(s, log_mu, log_nu, u)
    t_map = torch.exp(s + u[:, :, None, :] + v[:, None, :, :])
    return (t_map * cost).sum(dim=(1, 2))


def sinkhorn_pixels_bwd_plain(pred: torch.Tensor, gt_idx: torch.Tensor,
                              g: torch.Tensor, iters: int,
                              eps: float = 1.0) -> torch.Tensor:
    """Plain version of K5: dL/dpred (B, D, N) for the per-pixel cotangent
    g (B, N), by the TPU kernel's replay and reverse sweep, step by step."""
    s, cost, log_mu, log_nu = _marginals(pred, gt_idx, eps)
    u = torch.zeros_like(log_nu)
    v = torch.zeros_like(log_nu)
    history = []
    for _ in range(iters):
        u, v = _iterate(s, log_mu, log_nu, u)
        history.append((u, v))
    tc = torch.exp(s + u[:, :, None, :] + v[:, None, :, :]) * cost  # (B, Di, Dj, N)
    du = tc.sum(dim=2) * g[:, None, :]
    dv = tc.sum(dim=1) * g[:, None, :]
    dlog_nu = torch.zeros_like(log_nu)
    for t in range(iters - 1, -1, -1):
        v_t = history[t][1]
        # u_t = log_nu - LSE_j(S_ij + v_t_j): dlog_nu += du;
        # dv_t -= sum_i du_i P_ij, P = softmax_j(S + v_t)
        e = s + v_t[:, None, :, :]
        p = torch.exp(e - e.amax(dim=2, keepdim=True))
        p = p / p.sum(dim=2, keepdim=True)
        dlog_nu = dlog_nu + du
        dv_t = dv - (du[:, :, None, :] * p).sum(dim=1)
        if t == 0:  # u_{-1} = 0 is a constant: nothing flows further
            break
        # v_t = log_mu - LSE_i(S_ij + u_{t-1}_i):
        # du_{t-1} = -sum_j dv_t_j Q_ij, Q = softmax_i(S + u_{t-1})
        e = s + history[t - 1][0][:, :, None, :]
        q = torch.exp(e - e.amax(dim=1, keepdim=True))
        q = q / q.sum(dim=1, keepdim=True)
        du = -(dv_t[:, None, :, :] * q).sum(dim=2)
        dv = torch.zeros_like(dv)
    return dlog_nu / (pred + 1e-12)


class LaunchPlan(NamedTuple):
    """How K4 and K5 run D bins (csrc/sinkhorn_ot.cu)."""

    design: str    # "lanes" (L threads a pixel, D <= 32) or "thread" (one)
    lanes: int     # threads a pixel: L, the smallest power of two >= D; 1
    capacity: int  # the template instance: L; 4, 8 or 64 for "thread"
    threads: int   # the block
    smem: int      # dynamic shared bytes: K5's (u, v) history and, for
    #                "lanes", its transpose tiles; 0 for K4


def capacity(d: int) -> int:
    """The lanes a pixel for D bins: L, the smallest power of two >= D, up
    to 32 bins, else 64 (one thread a pixel, arrays of 64); raises outside
    1 <= D <= MAX_D."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the CUDA Sinkhorn kernels take 1 <= D <= {MAX_D} bins, got D={d}")
    return 1 << (d - 1).bit_length() if d <= MAX_LANES else MAX_D


@functools.lru_cache(maxsize=None)
def plan_launch(kernel: str, d: int, iters: int, pixels: int) -> LaunchPlan:
    """The launch of K4 ("fwd") or K5 ("bwd") for D bins, `iters`
    iterations and B * N pixels.  D lanes a pixel up to 32 bins, except
    from the pixels of THREAD_FROM at its D: there, and above 32 bins, one
    thread a pixel.  K4's block is fixed; K5 keeps 4 (2 iters + L + 1)
    bytes a thread in shared memory with lanes (its history and a pixel's
    L x (L + 1) tile over its L threads), 8 iters D with one thread a
    pixel, and its block is the largest of 256, 128, 64 and 32 threads
    within 48 KB, else 32 threads with a larger limit.  Raises where 32
    threads do not fit in SMEM_BYTES_MAX."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    cap = capacity(d)
    if d <= MAX_LANES and pixels < THREAD_FROM[kernel].get(d, pixels + 1):
        design, lanes, per_thread = "lanes", cap, 4 * (2 * iters + cap + 1)
    else:
        design, lanes, per_thread = "thread", 1, 8 * iters * d
        cap = next(m for m in THREAD_CAPACITIES if d <= m)
    if kernel == "fwd":
        return LaunchPlan(design, lanes, cap, THREADS if design == "lanes" else THREAD_FWD, 0)
    threads = next((n for n in _BLOCKS if per_thread * n <= _SMEM_DEFAULT), _BLOCKS[-1])
    if per_thread * threads > SMEM_BYTES_MAX:
        raise ValueError(
            f"iters={iters} at D={d} needs {per_thread * threads} bytes of shared "
            f"memory for K5 at {threads} threads, more than the {SMEM_BYTES_MAX} a "
            f"block may have"
        )
    return LaunchPlan(design, lanes, cap, threads, per_thread * threads)


def _check_inputs(pred, gt_idx, g=None):
    if pred.dim() != 3:
        raise ValueError(f"pred must be (B, D, N), got {tuple(pred.shape)}")
    b, d, n = pred.shape
    capacity(d)
    check_tensor("pred", pred, pred.device, torch.float32, (b, d, n))
    check_tensor("gt_idx", gt_idx, pred.device, torch.int32, (b, n))
    if g is not None:
        check_tensor("g", g, pred.device, torch.float32, (b, n))
    return b, d, n


def sinkhorn_fwd(pred: torch.Tensor, gt_idx: torch.Tensor, iters: int,
                 eps: float = 1.0) -> torch.Tensor:
    """K4: per-pixel loss (B, N) of pred (B, D, N) against gt_idx (B, N)."""
    if pred.device.type == "cpu":
        return sinkhorn_pixels_plain(pred, gt_idx, iters, eps)
    if pred.device.type != "cuda":
        raise ValueError(f"no kernel for device {pred.device}")
    b, d, n = _check_inputs(pred, gt_idx)
    plan = plan_launch("fwd", d, int(iters), b * n)
    lib = load_library()
    loss = torch.empty((b, n), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mvster_sinkhorn_fwd(pred.data_ptr(), gt_idx.data_ptr(), loss.data_ptr(),
                                     b, n, d, int(iters), float(eps),
                                     DESIGNS.index(plan.design), plan.capacity, plan.threads,
                                     stream)
    raise_on_error(lib, rc, "mvster_sinkhorn_fwd")
    sinkhorn_fwd.launches += 1
    return loss


def sinkhorn_bwd(pred: torch.Tensor, gt_idx: torch.Tensor, g: torch.Tensor,
                 iters: int, eps: float = 1.0) -> torch.Tensor:
    """K5: dL/dpred (B, D, N) for the per-pixel cotangent g (B, N)."""
    if pred.device.type == "cpu":
        return sinkhorn_pixels_bwd_plain(pred, gt_idx, g, iters, eps)
    if pred.device.type != "cuda":
        raise ValueError(f"no kernel for device {pred.device}")
    b, d, n = _check_inputs(pred, gt_idx, g)
    plan = plan_launch("bwd", d, int(iters), b * n)
    lib = load_library()
    dpred = torch.empty((b, d, n), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mvster_sinkhorn_bwd(pred.data_ptr(), gt_idx.data_ptr(), g.data_ptr(),
                                     dpred.data_ptr(), b, n, d, int(iters), float(eps),
                                     DESIGNS.index(plan.design), plan.capacity,
                                     plan.threads, plan.smem, stream)
    raise_on_error(lib, rc, "mvster_sinkhorn_bwd")
    sinkhorn_bwd.launches += 1
    return dpred


sinkhorn_fwd.launches = 0
sinkhorn_bwd.launches = 0


class _SinkhornPixels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, gt_idx, iters, eps):
        ctx.save_for_backward(pred, gt_idx)
        ctx.iters, ctx.eps = iters, eps
        return sinkhorn_fwd(pred, gt_idx, iters, eps)

    @staticmethod
    def backward(ctx, g):
        pred, gt_idx = ctx.saved_tensors
        return sinkhorn_bwd(pred, gt_idx, g.contiguous(), ctx.iters, ctx.eps), None, None, None


def sinkhorn_pixels(pred: torch.Tensor, gt_idx: torch.Tensor, iters: int,
                    eps: float = 1.0) -> torch.Tensor:
    """Per-pixel loss (B, N) with K4 forward and K5 backward; gt_idx gets no
    gradient."""
    return _SinkhornPixels.apply(pred, gt_idx, iters, eps)


def sinkhorn_loss_fused(gt_depth: torch.Tensor, hypo_depth: torch.Tensor,
                        attn_weight: torch.Tensor, mask: torch.Tensor,
                        iters: int = 10, eps: float = 1.0) -> torch.Tensor:
    """Masked-mean discrete Sinkhorn OT loss through K4/K5: gt_depth
    (B, H, W), hypo_depth and attn_weight (B, D, H, W), mask (B, H, W).
    The same value as core.sinkhorn(..., continuous=False)[1], over the
    global batch under a process group."""
    b, d, h, w = attn_weight.shape
    pred = attn_weight.float().reshape(b, d, h * w).contiguous()
    diff = (hypo_depth.float() - gt_depth.float()[:, None]).abs()
    # the first nearest hypothesis, as jnp.argmin picks it
    gt_idx = torch.argmin(diff, dim=1).reshape(b, h * w).to(torch.int32)
    per_pixel = sinkhorn_pixels(pred, gt_idx, iters, eps)
    m = mask.reshape(b, h * w).float()
    return global_mean((per_pixel * m).sum(), m.sum())
