"""The plain reference of MVSTER's training losses and its Adam steps.

The loss of the published DTU recipe (MVSTER models/MVS4Net.py
`MVS4net_loss`): per stage the entropy-regularised optimal transport
between the predicted distribution over the D hypotheses and the one-hot
GT bin (log-domain Sinkhorn, `iters` iterations, eps 1), averaged over
the valid pixels, plus `l1ot_lw[0]` times the masked L1 of the monocular
depth (stages 2-4); summed over the stages with `stage_lw`.  The BlendedMVS
fine-tune's `Blend_loss` has the same total and adds the final stage's
depth-normalised EPE.  Adam (torch's update, no weight decay) with the
warm-up of the published WarmupMultiStepLR.  Plain torch only.
"""

from __future__ import annotations

import torch


def sinkhorn_loss(gt, hypo, attn, mask, iters=10, eps=1.0):
    """Masked mean over pixels of <T, C> between attn (B, D, H, W) and the
    one-hot bin of the hypothesis nearest to gt (B, H, W)."""
    b, d, h, w = attn.shape
    bins = torch.arange(d, dtype=attn.dtype, device=attn.device)
    cost = (bins[:, None] - bins[None, :]).abs() / eps  # (D, D)
    gt_idx = (hypo - gt[:, None]).abs().argmin(1).reshape(b, h * w)
    gt_dist = torch.nn.functional.one_hot(gt_idx, d).to(attn.dtype)
    log_mu = torch.log(gt_dist + 1e-12)
    log_nu = torch.log(attn.permute(0, 2, 3, 1).reshape(b, h * w, d) + 1e-12)
    u = torch.zeros_like(log_nu)
    v = torch.zeros_like(log_mu)
    for _ in range(iters):
        v = log_mu - torch.logsumexp(cost + u[..., None], dim=2)
        u = log_nu - torch.logsumexp(cost + v[..., None, :], dim=3)
    plan = torch.exp(cost + u[..., None] + v[..., None, :])
    per_pixel = (plan * cost * eps).sum((2, 3)).reshape(-1)
    m = mask.reshape(-1).to(attn.dtype)
    return (per_pixel * m).sum() / m.sum().clamp(min=1.0)


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def mvs4net_loss(outs, mono, depth_gt, mask, stage_lw=(1, 1, 1, 1), l1ot_lw=(0, 1),
                 iters=10, eps=1.0):
    """(total, [per-stage OT terms])."""
    total, ot_terms = 0.0, []
    for s, key in enumerate(sorted(outs, key=lambda k: int(k[5:]))):
        valid = mask[key] > 0.5
        gt = depth_gt[key]
        l1 = masked_mean((mono[key] - gt).abs(), valid) if key in mono else 0.0
        ot = sinkhorn_loss(gt, outs[key]["hypo"], outs[key]["attn"], valid, iters, eps)
        ot_terms.append(ot)
        total = total + stage_lw[s] * (l1ot_lw[0] * l1 + l1ot_lw[1] * ot)
    return total, ot_terms


def blend_loss(outs, mono, depth_gt, mask, depth_values, **kw):
    """(total, [per-stage OT terms], epe): mvs4net_loss and the final
    stage's EPE with depths scaled to 128 over the depth range."""
    total, ot_terms = mvs4net_loss(outs, mono, depth_gt, mask, **kw)
    scale = (128.0 / (depth_values[:, -1] - depth_values[:, 0]))[:, None, None]
    err = (outs["stage4"]["depth"] - depth_gt["stage4"]).abs() * scale
    return total, ot_terms, masked_mean(err, mask["stage4"] > 0.5)


def warmup_factor(step, warmup_iters=500, start=1.0 / 3):
    """The published WarmupMultiStepLR's factor before its first milestone."""
    alpha = min(step, warmup_iters) / warmup_iters
    return start * (1.0 - alpha) + alpha


def train_steps(forward, sd, cfg, batches, lr=1e-3, betas=(0.9, 0.999), adam_eps=1e-8,
                iters=10, stage_depths=None):
    """Adam steps of a reference's cascade (its `forward`) and the loss from
    the state dict sd, one a batch (dicts of tensors: imgs, proj_matrices,
    depth_values, depth, mask).  `stage_depths`, one {stage: depth} a step
    or None, replays a trained cascade's windows (model.forward).  Returns
    (losses, grads, params, depths, volumes): each step's [total, OT terms]
    as floats, the first step's gradient of every parameter, the parameters
    after the last step, each step's stage depths, and each step's {stage:
    (hypo, attn)}.  Buffers (the BatchNorm running statistics) are left as
    they are: training normalises by the batch."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()
              if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    buffers = {k: v for k, v in sd.items() if k not in params}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads, depths, volumes = [], None, [], []
    for t, batch in enumerate(batches, start=1):
        forced = stage_depths[t - 1] if stage_depths is not None else None
        outs, mono = forward({**params, **buffers}, cfg, batch["imgs"],
                             batch["proj_matrices"], batch["depth_values"], train=True,
                             stage_depths=forced)
        depths.append({k: o["depth"].detach() for k, o in outs.items()})
        volumes.append({k: (o["hypo"].detach(), o["attn"].detach()) for k, o in outs.items()})
        total, ot_terms = mvs4net_loss(outs, mono, batch["depth"], batch["mask"],
                                       iters=iters)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        losses.append([float(x.detach()) for x in [total, *ot_terms]])
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), grads)]
        if t == 1:
            first_grads = {k: g.clone() for k, g in zip(params, grads)}
        step_lr = lr * warmup_factor(t - 1)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                v2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                denom = (v2[k].sqrt() / (1 - betas[1] ** t) ** 0.5).add_(adam_eps)
                p.addcdiv_(m[k], denom, value=-step_lr / (1 - betas[0] ** t))
    return losses, first_grads, {k: p.detach() for k, p in params.items()}, depths, volumes
