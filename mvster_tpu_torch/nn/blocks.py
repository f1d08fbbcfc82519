"""Conv + BatchNorm + ReLU blocks (counterpart of mvster_tpu.nn.blocks).

NCHW / NCDHW layouts, as cuDNN wants them.  Module and parameter names
follow the reference checkpoint's state-dict grammar
(tools/convert.py): `conv` / `bn` inside the blocks, `0` / `1` for the
transposed conv and its norm, `linear_agg.{0|2}`, `pixel_conv` and
`spatial_conv` in the attention blocks.  The convolutions have no bias,
since a norm follows each one.

Compute dtype: Conv2d, Conv3d and ConvTranspose3d take `dtype`; given
one (torch.bfloat16), they cast their input and weight to it and return
it, as flax's `nn.Conv(dtype=...)` does, while the parameters stay
float32.  The norms compute in their parameters' dtype (float32), whatever
the input's, as the JAX package's norms do.

BatchNorm (eps 1e-5, momentum 0.1 = flax's 0.9) follows flax in training:
it normalises with the batch's mean and biased variance, as torch does, and
updates the running buffers with that same biased variance, where torch's
own BatchNorm would take the unbiased one.  Under a process group of more
than one rank the moments are those of the global batch, as in the JAX
package's data-parallel step: one all_reduce of each channel's sum, sum
of squares and count, the variance as flax's E[x^2] - E[x]^2, and the
gradient through the sums (dist/reduce.AllSum).  The same arithmetic runs
where a channel holds one value (Reg3d's deepest level at small sizes):
flax's mean x and variance 0, where F.batch_norm refuses.
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
        x = x.to(self.weight.dtype)
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if world_size() > 1 or x.numel() == x.shape[1]:
            return self._moments_forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[0, *range(2, x.dim())], unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y

    def _moments_forward(self, x: torch.Tensor) -> torch.Tensor:
        """flax's arithmetic from each channel's sums, over the global
        batch under a process group of more than one rank."""
        dims = [0, *range(2, x.dim())]
        count = x.new_full((1,), x.numel() // x.shape[1])
        sums = torch.cat([x.sum(dims), (x * x).sum(dims), count])
        if world_size() > 1:
            sums = AllSum.apply(sums)
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


class _ComputeDtype:
    """A conv that runs in `dtype` when given one (see the module docstring)."""

    def __init__(self, *args, dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def _cast(self, x: torch.Tensor):
        dt = self.compute_dtype
        if dt is None:
            return x, self.weight, self.bias
        bias = None if self.bias is None else self.bias.to(dt)
        return x.to(dt), self.weight.to(dt), bias

    def _run(self, conv, x: torch.Tensor) -> torch.Tensor:
        """conv(x, weight, bias) in the compute dtype.  On a CPU tensor a
        bfloat16 conv sums the same bf16 values in float32 and rounds the
        result once, as cuDNN's and XLA's bf16 convs do: PyTorch's CPU
        bf16 3D convs return wrong values and gradients at small sizes (a
        stride-2 conv's output and weight gradient, a transposed conv's
        input gradient, where a level is a column or two wide)."""
        x, w, b = self._cast(x)
        if x.dtype == torch.bfloat16 and x.device.type == "cpu":
            return conv(x.float(), w.float(), None if b is None else b.float()).to(x.dtype)
        return conv(x, w, b)


class Conv2d(_ComputeDtype, nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(self._conv_forward, x)


class Conv3d(_ComputeDtype, nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(self._conv_forward, x)


class ConvTranspose3d(_ComputeDtype, nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(lambda x, w, b: F.conv_transpose3d(
            x, w, b, self.stride, self.padding, self.output_padding, self.groups,
            self.dilation), x)


class ConvBlock2d(nn.Module):
    """Conv2d (no bias) -> BatchNorm2d -> optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, relu: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=False, dtype=dtype)
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
                 pad: int | Sequence[int] = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels, kernel_size, stride,
                           pad, bias=False, dtype=dtype)
        self.bn = BatchNorm3d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class _AttentionBlock(ConvBnReLU3D):
    """Conv3d, a sigmoid gate multiplied into its output, the residual
    `+ input`, then BatchNorm3d and ReLU (mvster_tpu.nn.blocks.ConvBnReLU3D_*).
    The input and output channels are equal; the blocks get no compute
    dtype, as in the JAX package.  Subclasses define `gate(y)`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return torch.relu(self.bn(y * self.gate(y) + x))


class _ChannelAttention(_AttentionBlock):
    """The gates pool over H.  On a band of image rows `row_band` is the
    band (dist/spatial.RowBand, set while the step runs), and the pools are
    the whole image's."""

    row_band = None

    def __init__(self, in_channels: int, out_channels: int, **kwargs):
        super().__init__(in_channels, out_channels, **kwargs)
        self.linear_agg = nn.Sequential(
            nn.Linear(out_channels, out_channels // 2), nn.ReLU(),
            nn.Linear(out_channels // 2, out_channels))

    def _pools(self, y, dims):
        """y's mean and max over `dims`, the whole image's."""
        if self.row_band is None:
            return y.mean(dims), y.amax(dims)
        return self.row_band.mean(y, dims), self.row_band.amax(y, dims)


class ConvBnReLU3D_CAM(_ChannelAttention):
    """Channel gates from the mean and max over (D, H, W), through one MLP."""

    def gate(self, y):
        mean, amax = self._pools(y, (2, 3, 4))
        a = self.linear_agg(mean) + self.linear_agg(amax)
        return torch.sigmoid(a)[:, :, None, None, None]


class ConvBnReLU3D_DCAM(_ChannelAttention):
    """Channel gates per depth plane, from the mean and max over (H, W)."""

    def gate(self, y):
        mean, amax = self._pools(y, (3, 4))
        a = (self.linear_agg(mean.transpose(1, 2))
             + self.linear_agg(amax.transpose(1, 2)))  # (B, D, C)
        return torch.sigmoid(a).transpose(1, 2)[..., None, None]


class ConvBnReLU3D_PAM(_AttentionBlock):
    """Pixel gates: a 7x7 conv (with bias) over [max, mean] taken over (C, D)."""

    def __init__(self, in_channels: int, out_channels: int, **kwargs):
        super().__init__(in_channels, out_channels, **kwargs)
        self.pixel_conv = nn.Conv2d(2, 1, 7, padding=3, bias=True)

    def gate(self, y):
        stats = torch.stack([y.amax((1, 2)), y.mean((1, 2))], dim=1)  # (B, 2, H, W)
        return torch.sigmoid(self.pixel_conv(stats))[:, :, None]


class ConvBnReLU3D_PDAM(_AttentionBlock):
    """Pixel-depth gates: a 7x7x7 conv (with bias) over [max, mean] over C."""

    def __init__(self, in_channels: int, out_channels: int, **kwargs):
        super().__init__(in_channels, out_channels, **kwargs)
        self.spatial_conv = nn.Conv3d(2, 1, 7, padding=3, bias=True)

    def gate(self, y):
        stats = torch.cat([y.amax(1, keepdim=True), y.mean(1, keepdim=True)], dim=1)
        return torch.sigmoid(self.spatial_conv(stats))


AGG_BLOCKS = {
    "ConvBnReLU3D": ConvBnReLU3D,
    "ConvBnReLU3D_CAM": ConvBnReLU3D_CAM,
    "ConvBnReLU3D_DCAM": ConvBnReLU3D_DCAM,
    "ConvBnReLU3D_PAM": ConvBnReLU3D_PAM,
    "ConvBnReLU3D_PDAM": ConvBnReLU3D_PDAM,
}


class ConvTransposeBnReLU3d(nn.Sequential):
    """The U-Nets' upsampling block: a transposed conv without bias that
    doubles each axis of stride 2 (torch's padding 1, output_padding 1: the
    JAX package's input-dilated form with padding (1, 2)), then
    BatchNorm3d and ReLU.  Reg2d takes the (1, 3, 3) kernel with stride
    (1, 2, 2), Reg3d the (3, 3, 3) one with stride (2, 2, 2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (1, 3, 3),
                 stride: Sequence[int] = (1, 2, 2),
                 dtype: torch.dtype | None = None):
        super().__init__(
            ConvTranspose3d(in_channels, out_channels, kernel_size=tuple(kernel_size),
                            stride=tuple(stride),
                            padding=tuple((k - 1) // 2 for k in kernel_size),
                            output_padding=tuple(s - 1 for s in stride),
                            bias=False, dtype=dtype),
            BatchNorm3d(out_channels, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )
