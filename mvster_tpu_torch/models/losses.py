"""Training losses: per-stage Sinkhorn OT supervision + mono L1 (counterpart of mvster_tpu.models.losses).

Masked-mean reductions in float32, over the global batch under a process
group of several ranks (dist/reduce.global_mean), as in the JAX package's
data-parallel step.  The reference's training script passes
`l1ce_lw` while its loss reads `l1ot_lw`, so its published runs always used
the default (0, 1), pure OT; here, as in the JAX package, `l1ot_lw` is read
for real and defaults to (0, 1).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from mvster_tpu_torch.core.sinkhorn import sinkhorn
from mvster_tpu_torch.dist.reduce import global_mean
from mvster_tpu_torch.kernels.sinkhorn_ot import sinkhorn_loss_fused


def _sinkhorn_loss(gt, hypo, attn, mask, iters, eps, continuous, backend="xla"):
    """The Sinkhorn loss.  ot_backend="pallas" with discrete OT runs the
    fused kernels K4 (forward) and K5 (backward) of kernels/sinkhorn_ot.py,
    as the JAX package runs its Pallas pair; otherwise the plain iterations
    are recomputed in the backward instead of keeping their (B, HW, D, D)
    residuals, as the JAX package's jax.checkpoint."""
    if backend == "pallas" and not continuous:
        return sinkhorn_loss_fused(gt, hypo, attn, mask, iters, eps)
    return checkpoint(
        lambda g, h, a, m: sinkhorn(g, h, a, m, iters=iters, eps=eps,
                                    continuous=continuous)[1],
        gt, hypo, attn, mask, use_reentrant=False,
    )


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return global_mean((x.float() * m).sum(), m.sum())


def _stage_items(outputs: dict[str, Any]):
    keys = sorted((k for k in outputs if k.startswith("stage")),
                  key=lambda s: int(s[5:]))
    return [(k, outputs[k]) for k in keys]


def mvs4net_loss(
    outputs: dict[str, Any],
    depth_gt_ms: dict[str, torch.Tensor],
    mask_ms: dict[str, torch.Tensor],
    *,
    stage_lw=(1.0, 1.0, 1.0, 1.0),
    l1ot_lw=(0.0, 1.0),
    inverse_depth: bool = False,
    ot_iter: int = 10,
    ot_eps: float = 1.0,
    ot_continous: bool = False,
    mono: bool = False,
    ot_backend: str = "xla",
    depth_values=None,  # accepted for interface parity with blend_loss
):
    """Total loss and per-stage diagnostics: (total, aux) with aux =
    {stage_l1_loss, stage_ot_loss, range_err_ratio}, lists of scalars in
    stage order."""
    device = next(iter(depth_gt_ms.values())).device
    total = torch.zeros((), device=device)
    stage_l1, stage_ot, range_err = [], [], []
    for stage_idx, (key, stage_out) in enumerate(_stage_items(outputs)):
        hypo = stage_out["hypo_depth"]
        attn = stage_out["attn_weight"]
        mask = mask_ms[key] > 0.5
        gt = depth_gt_ms[key]

        if mono and stage_idx != 0:
            l1 = _masked_mean((stage_out["mono_depth"] - gt).abs(), mask)
        else:
            l1 = torch.zeros((), device=device)

        # fraction of valid pixels whose GT lies outside the hypothesis range
        with torch.no_grad():
            if inverse_depth:
                itv = (1.0 / hypo[:, 2] - 1.0 / hypo[:, 1]).abs()
                inside = (1.0 / hypo - 1.0 / gt[:, None]).abs() <= itv[:, None]
            else:
                itv = (hypo[:, 2] - hypo[:, 1]).abs()
                inside = (hypo - gt[:, None]).abs() <= itv[:, None]
            out_of_range = inside.sum(dim=1) == 0
            range_err.append(_masked_mean(out_of_range, mask))

        ot = _sinkhorn_loss(gt, hypo, attn, mask, ot_iter, ot_eps, ot_continous,
                            ot_backend)
        stage_l1.append(l1)
        stage_ot.append(ot)
        total = total + stage_lw[stage_idx] * (l1ot_lw[0] * l1 + l1ot_lw[1] * ot)

    aux = {"stage_l1_loss": stage_l1, "stage_ot_loss": stage_ot,
           "range_err_ratio": range_err}
    return total, aux


def blend_loss(
    outputs: dict[str, Any],
    depth_gt_ms: dict[str, torch.Tensor],
    mask_ms: dict[str, torch.Tensor],
    *,
    depth_values: torch.Tensor = None,
    depth_min: torch.Tensor = None,
    depth_max: torch.Tensor = None,
    stage_lw=(1.0, 1.0, 1.0, 1.0),
    l1ot_lw=(0.0, 1.0),
    inverse_depth: bool = False,
    ot_iter: int = 10,
    ot_eps: float = 1.0,
    ot_continous: bool = False,
    ot_backend: str = "xla",
    mono: bool = False,
):
    """BlendedMVS fine-tune variant: adds the depth-normalised EPE, err1 and
    err3 of the final stage.  depth_min / depth_max (B,) default to
    depth_values[:, 0] / [:, -1]."""
    if depth_min is None:
        depth_min = depth_values[:, 0]
    if depth_max is None:
        depth_max = depth_values[:, -1]
    total, aux = mvs4net_loss(
        outputs, depth_gt_ms, mask_ms, stage_lw=stage_lw, l1ot_lw=l1ot_lw,
        inverse_depth=inverse_depth, ot_iter=ot_iter, ot_eps=ot_eps,
        ot_continous=ot_continous, ot_backend=ot_backend, mono=mono,
    )
    last_key, last = _stage_items(outputs)[-1]
    mask = mask_ms[last_key] > 0.5
    scale = (128.0 / (depth_max - depth_min))[:, None, None]
    abs_err = (last["depth"] * scale - depth_gt_ms[last_key] * scale).abs()
    aux = dict(aux)
    aux["epe"] = _masked_mean(abs_err, mask)
    aux["err3"] = _masked_mean(abs_err <= 3.0, mask) * 100.0
    aux["err1"] = _masked_mean(abs_err <= 1.0, mask) * 100.0
    return total, aux
