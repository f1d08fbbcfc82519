"""Depth-quality metrics and running averages (counterpart of mvster_tpu.train.metrics).

The reference's metric set: per-image masked absolute depth error and the
fraction of pixels above 2/4/8 mm, averaged over images; images with no
valid pixel are left out of that average, which lets eval pad a trailing
partial batch with zero-mask duplicates and still report the unpadded
batch's metric.  Under a process group of several ranks the per-image
means and the count of valid images are summed over the ranks, so the
metrics are those of the global batch, as in the JAX package's
data-parallel step.  Where the ranks of a spatial group each hold a band
of an image's rows (dist/spatial.py), `group` names that group: each
image's masked sum and pixel count are summed over it before the division,
so the per-image means are those of whole images, as in the JAX package's
spatial step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mvster_tpu_torch.dist.reduce import global_mean


def _per_image_masked_mean(values, mask, group=None):
    m = mask.float()
    num, msum = (values * m).sum(dim=(1, 2)), m.sum(dim=(1, 2))
    if group is not None:  # the whole images' sums from their bands
        sums = torch.stack([num, msum])
        dist.all_reduce(sums, group=group)
        num, msum = sums[0], sums[1]
    per = num / msum.clamp(min=1.0)
    w = (msum > 0).float()
    return global_mean((per * w).sum(), w.sum())


def thres_metric(depth_est, depth_gt, mask, thres: float, group=None):
    """Mean over images of the fraction of valid pixels with |err| > thres."""
    return _per_image_masked_mean(((depth_est - depth_gt).abs() > thres).float(), mask,
                                  group)


def abs_depth_error(depth_est, depth_gt, mask, group=None):
    """Mean over images of the masked mean absolute depth error."""
    return _per_image_masked_mean((depth_est - depth_gt).abs(), mask, group)


def depth_metrics(depth_est, depth_gt, mask, group=None):
    """The reference scalar set: abs error and the >2/4/8 mm fractions;
    `group`, the spatial group whose ranks hold the images' bands."""
    return {
        "abs_depth_error": abs_depth_error(depth_est, depth_gt, mask, group),
        "thres2mm_error": thres_metric(depth_est, depth_gt, mask, 2.0, group),
        "thres4mm_error": thres_metric(depth_est, depth_gt, mask, 4.0, group),
        "thres8mm_error": thres_metric(depth_est, depth_gt, mask, 8.0, group),
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
