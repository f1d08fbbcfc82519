"""Conv + BatchNorm + ReLU blocks (counterpart of mvster_tpu.nn.blocks).

NCHW / NCDHW layouts, as cuDNN wants them.  Module and parameter names
follow the reference checkpoint's state-dict grammar
(tools/convert.py): `conv` / `bn` inside the blocks, `0` / `1` for the
transposed conv and its norm.  The convolutions have no bias, since a norm
follows each one.

BatchNorm (eps 1e-5, momentum 0.1 = flax's 0.9) follows flax in training:
it normalises with the batch's mean and biased variance, as torch does, and
updates the running buffers with that same biased variance, where torch's
own BatchNorm would take the unbiased one.  Under a process group of more
than one rank the moments are those of the global batch, as in the JAX
package's data-parallel step: one all_reduce of each channel's sum, sum
of squares and count, the variance as flax's E[x^2] - E[x]^2, and the
gradient through the sums (dist/reduce.AllSum).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mvster_tpu_torch.dist.mesh import world_size
from mvster_tpu_torch.dist.reduce import AllSum


class _FlaxStats:
    """Train-mode BatchNorm with flax's running-statistics update."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if world_size() > 1:
            return self._global_batch_forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[0, *range(2, x.dim())], unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0, *range(2, x.dim())]
        count = x.new_full((1,), x.numel() // x.shape[1])
        sums = AllSum.apply(torch.cat([x.sum(dims), (x * x).sum(dims), count]))
        c = x.shape[1]
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp(min=0.0)
        shape = (1, c) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxStats, nn.BatchNorm3d):
    pass


class ConvBlock2d(nn.Module):
    """Conv2d (no bias) -> BatchNorm2d -> optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class ConvBnReLU3D(nn.Module):
    """Conv3d (no bias) -> BatchNorm3d -> ReLU on (B, C, D, H, W) volumes."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int | Sequence[int] = 3,
                 stride: int | Sequence[int] = 1,
                 pad: int | Sequence[int] = 1):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, stride,
                              pad, bias=False)
        self.bn = BatchNorm3d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class ConvTransposeBnReLU3d(nn.Sequential):
    """The reg2d upsampling block: a (1, 3, 3) transposed conv with stride
    (1, 2, 2) that doubles H and W, then BatchNorm3d and ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            nn.ConvTranspose3d(in_channels, out_channels, kernel_size=(1, 3, 3),
                               stride=(1, 2, 2), padding=(0, 1, 1),
                               output_padding=(0, 1, 1), bias=False),
            BatchNorm3d(out_channels, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )
