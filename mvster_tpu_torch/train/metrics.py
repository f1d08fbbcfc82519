"""Depth-quality metrics and running averages (counterpart of mvster_tpu.train.metrics).

The reference's metric set: per-image masked absolute depth error and the
fraction of pixels above 2/4/8 mm, averaged over images; images with no
valid pixel are left out of that average, which lets eval pad a trailing
partial batch with zero-mask duplicates and still report the unpadded
batch's metric.
"""

from __future__ import annotations

import torch


def _per_image_masked_mean(values, mask):
    m = mask.float()
    msum = m.sum(dim=(1, 2))
    per = (values * m).sum(dim=(1, 2)) / msum.clamp(min=1.0)
    w = (msum > 0).float()
    return (per * w).sum() / w.sum().clamp(min=1.0)


def thres_metric(depth_est, depth_gt, mask, thres: float):
    """Mean over images of the fraction of valid pixels with |err| > thres."""
    return _per_image_masked_mean(((depth_est - depth_gt).abs() > thres).float(), mask)


def abs_depth_error(depth_est, depth_gt, mask):
    """Mean over images of the masked mean absolute depth error."""
    return _per_image_masked_mean((depth_est - depth_gt).abs(), mask)


def depth_metrics(depth_est, depth_gt, mask):
    """The reference scalar set: abs error and the >2/4/8 mm fractions."""
    return {
        "abs_depth_error": abs_depth_error(depth_est, depth_gt, mask),
        "thres2mm_error": thres_metric(depth_est, depth_gt, mask, 2.0),
        "thres4mm_error": thres_metric(depth_est, depth_gt, mask, 4.0),
        "thres8mm_error": thres_metric(depth_est, depth_gt, mask, 8.0),
    }


class DictAverageMeter:
    """Running mean of scalar dicts (epoch-level eval aggregation)."""

    def __init__(self):
        self.data: dict[str, float] = {}
        self.count = 0

    def update(self, scalars: dict):
        self.count += 1
        for k, v in scalars.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self) -> dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.data.items()}


def tree_to_float(tree):
    """Nested dicts/lists of tensors -> python floats (scalars) or lists."""
    if isinstance(tree, dict):
        return {k: tree_to_float(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_float(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.item() if tree.dim() == 0 else tree.tolist()
    return float(tree)
