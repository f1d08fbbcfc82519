"""Global-batch reductions across data-parallel ranks.

The JAX package's data-parallel step is one program over the global batch,
so its BatchNorm moments, masked-mean losses and depth metrics are those of
the global batch.  Under DistributedDataParallel each rank holds a shard;
these helpers make the same quantities global with sums over the ranks
(all_reduce only: gloo takes nothing else on CUDA tensors).  Without a
process group, or with one rank, each is the single-device arithmetic, op
for op.

DDP averages the ranks' gradients, so a quantity the loss is built from
keeps on each rank the gradient of the global quantity times the world
size: averaged, that is the global gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mvster_tpu_torch.dist.mesh import world_size


def _all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


class AllSum(torch.autograd.Function):
    """Sum over the ranks of `group` (the default group: every rank) whose
    gradient is the sum of those ranks' gradients: every rank's copy of the
    sum feeds its own loss."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        return _all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_sum(g.contiguous(), ctx.group), None


class _GlobalMean(torch.autograd.Function):
    """total / count in the forward; d/dnum = world / count in the backward."""

    @staticmethod
    def forward(ctx, num, total, count, world):
        ctx.save_for_backward(count)
        ctx.world = world
        return total / count

    @staticmethod
    def backward(ctx, g):
        (count,) = ctx.saved_tensors
        return g * ctx.world / count, None, None, None


def global_mean(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """num / max(count, 1), with the scalar numerator and count each summed
    over the ranks.  The count takes no gradient; a rank with count 0 adds
    nothing and still joins the collective."""
    world = world_size()
    if world == 1:
        return num / count.clamp(min=1.0)
    total = _all_sum(torch.stack([num.detach(), count.detach().to(num.dtype)]))
    return _GlobalMean.apply(num, total[0], total[1].clamp(min=1.0), world)
