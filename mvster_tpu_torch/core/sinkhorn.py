"""Entropy-regularised optimal-transport (Sinkhorn) depth supervision (counterpart of mvster_tpu.core.sinkhorn).

Log-domain Sinkhorn between the predicted attention distribution over the D
depth bins and the ground-truth bin distribution, with an optional
continuous variant that appends a dustbin column holding the fractional GT
bin distance.  Masked-mean reductions, a fixed iteration count, float32
throughout, and the reference's sign convention: the couplings are
exp(+cost/eps + u + v), the negative-cost convention folded into u and v.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sinkhorn(
    gt_depth: torch.Tensor,
    hypo_depth: torch.Tensor,
    attn_weight: torch.Tensor,
    mask: torch.Tensor,
    iters: int,
    eps: float = 1.0,
    continuous: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """OT loss between the predicted depth-bin distribution and the GT bin.

    gt_depth (B, H, W); hypo_depth and attn_weight (B, D, H, W); mask
    (B, H, W) bool.  Returns (t_map, loss): the transport plan
    (B, HW, D, Dcols), Dcols = D (+1 with the dustbin), and the masked mean
    over pixels of <T, C>.
    """
    gt_depth = gt_depth.float()
    hypo_depth = hypo_depth.float()
    attn_weight = attn_weight.float()
    b, d, h, w = attn_weight.shape
    hw = h * w
    bins = torch.arange(d, dtype=torch.float32, device=attn_weight.device)
    base_cost = (bins[:, None] - bins[None, :]).abs()  # (D, D)

    if not continuous:
        # GT distribution: one-hot at the hypothesis nearest to the GT depth;
        # torch.argmin returns the first minimum, as jnp.argmin does
        diff = (hypo_depth - gt_depth[:, None]).abs()
        gt_idx = torch.argmin(diff, dim=1).reshape(b, hw)
        gt_dist = F.one_hot(gt_idx, d).float()  # (B, HW, D)
        cost = base_cost.expand(b, hw, d, d)
    else:
        # all GT mass in the dustbin column, whose cost row is the continuous
        # distance from each bin to the fractional GT bin
        gt_dist = torch.zeros(b, hw, d + 1, device=attn_weight.device)
        gt_dist[..., -1] = 1.0
        itv = 1.0 / hypo_depth[:, 2] - 1.0 / hypo_depth[:, 1]
        gt_bin = (1.0 / gt_depth - 1.0 / hypo_depth[:, 0]) / itv
        gt_bin = torch.where(mask, gt_bin, torch.full_like(gt_bin, 10.0))
        gt_bin_dist = (gt_bin[..., None] - bins).abs()  # (B, H, W, D)
        cost = torch.cat([base_cost.expand(b, hw, d, d),
                          gt_bin_dist.reshape(b, hw, d, 1)], dim=-1)

    pred_dist = attn_weight.permute(0, 2, 3, 1).reshape(b, hw, d)
    log_mu = torch.log(gt_dist + 1e-12)  # (B, HW, Dcols)
    log_nu = torch.log(pred_dist + 1e-12)  # (B, HW, D)
    scaled = cost / eps

    u = torch.zeros_like(log_nu)
    v = torch.zeros_like(log_mu)
    for _ in range(iters):
        v = log_mu - torch.logsumexp(scaled + u[..., None], dim=2)
        u = log_nu - torch.logsumexp(scaled + v[..., None, :], dim=3)

    t_map = torch.exp(scaled + u[..., None] + v[..., None, :])
    per_pixel = (t_map * cost).sum(dim=(2, 3)).reshape(-1)
    mask_flat = mask.reshape(-1).float()
    loss = (per_pixel * mask_flat).sum() / mask_flat.sum().clamp(min=1.0)
    return t_map, loss
