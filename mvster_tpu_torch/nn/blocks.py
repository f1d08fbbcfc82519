"""Conv + BatchNorm + ReLU blocks (counterpart of mvster_tpu.nn.blocks).

NCHW / NCDHW layouts, as cuDNN wants them.  Module and parameter names
follow the reference checkpoint's state-dict grammar
(mvster_tpu/tools/convert_torch_ckpt.py): `conv` / `bn` inside the blocks,
`0` / `1` for the transposed conv and its norm.  BatchNorm uses torch's
eps 1e-5 and momentum 0.1 (flax's momentum 0.9).  The convolutions have no
bias, since a norm follows each one.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class ConvBlock2d(nn.Module):
    """Conv2d (no bias) -> BatchNorm2d -> optional ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
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
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-5, momentum=0.1)

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
            nn.BatchNorm3d(out_channels, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )
