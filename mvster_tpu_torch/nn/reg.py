"""Cost-volume regularisers (counterpart of mvster_tpu.nn.reg: Reg2d's standard branch, Reg3d).

Reg2d: a U-Net whose strided convolutions touch only H and W ((1, 3, 3)
kernels, stride (1, 2, 2)) while the aggregation blocks at each scale
(`agg_type`: the 3x3x3 ConvBnReLU3D, or its CAM/DCAM/PAM/PDAM attention
variants) mix the depth axis.  The JAX package's eval-only depth-folded
formulation (fold=True) computes the same function; the port runs the
standard one that the reference checkpoint defines.

Reg3d: the true-3D U-Net, stride 2 over D, H and W, with `down_size` 1, 2
or 3 levels; D, H and W must divide by 2 ** down_size.

Compute dtype (the JAX package's casts): Reg2d runs conv0/1/3/5 and the
transposed convs in `dtype`, the aggregation blocks too when they are the
default ConvBnReLU3D; its norms return float32, so its logit head runs
in float32.  Reg3d gets no dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from mvster_tpu_torch.nn.blocks import AGG_BLOCKS, ConvBnReLU3D, ConvTransposeBnReLU3d


class Reg2d(nn.Module):
    """(B, Cin, D, H, W) volume -> (B, D, H, W) float32 logits; H, W divisible by 8."""

    def __init__(self, input_channel: int, base_channel: int = 8,
                 agg_type: str = "ConvBnReLU3D", dtype: torch.dtype | None = None):
        super().__init__()
        b = base_channel
        agg = AGG_BLOCKS[agg_type]
        dkw = dict(dtype=dtype) if agg_type == "ConvBnReLU3D" else {}
        k133 = dict(kernel_size=(1, 3, 3), pad=(0, 1, 1), dtype=dtype)
        self.dtype = dtype
        self.conv0 = ConvBnReLU3D(input_channel, b, **k133)
        self.conv1 = ConvBnReLU3D(b, 2 * b, stride=(1, 2, 2), **k133)
        self.conv2 = agg(2 * b, 2 * b, **dkw)
        self.conv3 = ConvBnReLU3D(2 * b, 4 * b, stride=(1, 2, 2), **k133)
        self.conv4 = agg(4 * b, 4 * b, **dkw)
        self.conv5 = ConvBnReLU3D(4 * b, 8 * b, stride=(1, 2, 2), **k133)
        self.conv6 = agg(8 * b, 8 * b, **dkw)
        self.conv7 = ConvTransposeBnReLU3d(8 * b, 4 * b, dtype=dtype)
        self.conv9 = ConvTransposeBnReLU3d(4 * b, 2 * b, dtype=dtype)
        self.conv11 = ConvTransposeBnReLU3d(2 * b, b, dtype=dtype)
        self.prob = nn.Conv3d(b, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)[:, 0]


class Reg3d(nn.Module):
    """(B, Cin, D, H, W) volume -> (B, D, H, W) logits; stride-2 3x3x3
    convs over D, H and W, `down_size` levels down and up, and a 3x3x3
    logit head without bias."""

    def __init__(self, input_channel: int, base_channel: int = 8, down_size: int = 3):
        super().__init__()
        if down_size not in (1, 2, 3):
            raise ValueError(f"Reg3d down_size must be 1, 2 or 3, got {down_size}")
        b = base_channel
        self.down_size = down_size
        up = dict(kernel_size=(3, 3, 3), stride=(2, 2, 2))
        self.conv0 = ConvBnReLU3D(input_channel, b)
        self.conv1 = ConvBnReLU3D(b, 2 * b, stride=2)
        self.conv2 = ConvBnReLU3D(2 * b, 2 * b)
        if down_size >= 2:
            self.conv3 = ConvBnReLU3D(2 * b, 4 * b, stride=2)
            self.conv4 = ConvBnReLU3D(4 * b, 4 * b)
        if down_size == 3:
            self.conv5 = ConvBnReLU3D(4 * b, 8 * b, stride=2)
            self.conv6 = ConvBnReLU3D(8 * b, 8 * b)
            self.conv7 = ConvTransposeBnReLU3d(8 * b, 4 * b, **up)
        if down_size >= 2:
            self.conv9 = ConvTransposeBnReLU3d(4 * b, 2 * b, **up)
        self.conv11 = ConvTransposeBnReLU3d(2 * b, b, **up)
        self.prob = nn.Conv3d(b, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        x = conv2 = self.conv2(self.conv1(conv0))
        if self.down_size >= 2:
            x = conv4 = self.conv4(self.conv3(conv2))
            if self.down_size == 3:
                x = conv4 + self.conv7(self.conv6(self.conv5(conv4)))
            x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)[:, 0]
