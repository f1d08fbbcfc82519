"""Cost-volume regulariser (counterpart of mvster_tpu.nn.reg.Reg2d, standard branch).

A U-Net whose strided convolutions touch only H and W ((1, 3, 3) kernels,
stride (1, 2, 2)) while the 3x3x3 blocks at each scale mix the depth axis.
The JAX package's eval-only depth-folded formulation (fold=True) computes
the same function; the port runs the standard one that the reference
checkpoint defines.
"""

from __future__ import annotations

import torch
from torch import nn

from mvster_tpu_torch.nn.blocks import ConvBnReLU3D, ConvTransposeBnReLU3d


class Reg2d(nn.Module):
    """(B, Cin, D, H, W) volume -> (B, D, H, W) logits; H, W divisible by 8."""

    def __init__(self, input_channel: int, base_channel: int = 8):
        super().__init__()
        b = base_channel
        k133 = dict(kernel_size=(1, 3, 3), pad=(0, 1, 1))
        self.conv0 = ConvBnReLU3D(input_channel, b, **k133)
        self.conv1 = ConvBnReLU3D(b, 2 * b, stride=(1, 2, 2), **k133)
        self.conv2 = ConvBnReLU3D(2 * b, 2 * b)
        self.conv3 = ConvBnReLU3D(2 * b, 4 * b, stride=(1, 2, 2), **k133)
        self.conv4 = ConvBnReLU3D(4 * b, 4 * b)
        self.conv5 = ConvBnReLU3D(4 * b, 8 * b, stride=(1, 2, 2), **k133)
        self.conv6 = ConvBnReLU3D(8 * b, 8 * b)
        self.conv7 = ConvTransposeBnReLU3d(8 * b, 4 * b)
        self.conv9 = ConvTransposeBnReLU3d(4 * b, 2 * b)
        self.conv11 = ConvTransposeBnReLU3d(2 * b, b)
        self.prob = nn.Conv3d(b, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return self.prob(x)[:, 0]
