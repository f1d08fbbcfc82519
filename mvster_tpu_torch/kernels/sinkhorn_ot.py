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
`sinkhorn_bwd.launches` count kernel launches.

Layouts: pred (B, D, N) float32, the model's attention (B, D, H, W) as it
lies with N = H * W; gt_idx (B, N) integer GT bins; per-pixel loss and its
cotangent (B, N); dL/dpred (B, D, N).  The autograd Function keeps only
pred and gt_idx for its backward, never the transport plan.
`sinkhorn_loss_fused` is the contract of the JAX package's
sinkhorn_loss_pallas: the masked-mean loss of discrete OT, differentiable
with respect to attn_weight.
"""

from __future__ import annotations

import math

import torch

from mvster_tpu_torch.kernels._build import check_tensor, load_library, raise_on_error

_LOG_EPS = math.log(1e-12)
_LOG_ONE = math.log(1.0 + 1e-12)
MAX_D = 64  # the most bins K4/K5 take (dtu_default uses 8, 8, 4, 4)
CAPACITIES = (4, 8, 16, 32, 64)  # the kernels' template instances (MAXD)
SMEM_BYTES_MAX = 232_448  # dynamic shared memory one block may have (227 KB)
_SMEM_DEFAULT = 48 * 1024  # what a launch gets without raising its limit
_BWD_THREADS = (128, 64, 32)  # K5's block sizes, largest first


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


def capacity(d: int) -> int:
    """The kernel instance (MAXD, csrc/sinkhorn_ot.cu) that runs D bins: the
    smallest capacity that holds D; raises outside 1 <= D <= MAX_D."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the CUDA Sinkhorn kernels take 1 <= D <= {MAX_D} bins, got D={d}")
    return next(m for m in CAPACITIES if d <= m)


def bwd_launch_shape(d: int, iters: int) -> tuple[int, int]:
    """K5's (threads per block, dynamic shared-memory bytes) for D and
    iters: the (u, v) history takes iters * 2 * D floats per thread; the
    largest block of 128, 64 or 32 threads whose history fits in 48 KB,
    else 32 threads with a larger limit; raises where 32 threads do not
    fit in 227 KB."""
    per_thread = iters * 2 * d * 4
    for threads in _BWD_THREADS:
        if per_thread * threads <= _SMEM_DEFAULT:
            return threads, per_thread * threads
    threads = _BWD_THREADS[-1]
    if per_thread * threads > SMEM_BYTES_MAX:
        raise ValueError(
            f"iters={iters} at D={d} needs {per_thread * threads} bytes of shared "
            f"memory for K5's history at {threads} threads, more than the "
            f"{SMEM_BYTES_MAX} a block may have"
        )
    return threads, per_thread * threads


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
    lib = load_library()
    loss = torch.empty((b, n), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mvster_sinkhorn_fwd(pred.data_ptr(), gt_idx.data_ptr(), loss.data_ptr(),
                                     b, n, d, int(iters), float(eps), capacity(d), stream)
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
    threads, smem = bwd_launch_shape(d, int(iters))
    lib = load_library()
    dpred = torch.empty((b, d, n), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mvster_sinkhorn_bwd(pred.data_ptr(), gt_idx.data_ptr(), g.data_ptr(),
                                     dpred.data_ptr(), b, n, d, int(iters), float(eps),
                                     threads, smem, capacity(d), stream)
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
    The same value as core.sinkhorn(..., continuous=False)[1]."""
    b, d, h, w = attn_weight.shape
    pred = attn_weight.float().reshape(b, d, h * w).contiguous()
    diff = (hypo_depth.float() - gt_depth.float()[:, None]).abs()
    # the first nearest hypothesis, as jnp.argmin picks it
    gt_idx = torch.argmin(diff, dim=1).reshape(b, h * w).to(torch.int32)
    per_pixel = sinkhorn_pixels(pred, gt_idx, iters, eps)
    m = mask.reshape(b, h * w).float()
    return (per_pixel * m).sum() / m.sum().clamp(min=1.0)
