"""The 4-level feature pyramid (counterpart of mvster_tpu.nn.fpn.FPN4, standard branch).

A strided conv encoder, lateral 1x1 convs and an align-corners bilinear
top-down path.  Output channels [8b, 4b, 2b, b] at strides [8, 4, 2, 1],
keyed stage1..stage4.  The JAX package's eval-only composed tail
(compose_tail) is an algebraic rewrite of the same function; the port runs
the standard formulation that the reference checkpoint defines.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvster_tpu_torch.nn.blocks import ConvBlock2d


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class FPN4(nn.Module):
    """(N, 3, H, W) images -> {"stage1".."stage4": (N, C_s, H/2^(4-s), W/2^(4-s))}."""

    def __init__(self, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.out_channels = [8 * b, 4 * b, 2 * b, b]

        def encoder(cin, cout, first):
            k, s, p = first
            return nn.Sequential(
                ConvBlock2d(cin, cout, k, s, p),
                *[ConvBlock2d(cout, cout, 3, 1, 1) for _ in range(1 if s == 1 else 2)],
            )

        self.conv0 = encoder(3, b, (3, 1, 1))
        self.conv1 = encoder(b, 2 * b, (5, 2, 2))
        self.conv2 = encoder(2 * b, 4 * b, (5, 2, 2))
        self.conv3 = encoder(4 * b, 8 * b, (5, 2, 2))

        final = 8 * b
        self.out1 = nn.Conv2d(final, 8 * b, 1, bias=False)
        self.inner1 = nn.Conv2d(4 * b, final, 1, bias=True)
        self.inner2 = nn.Conv2d(2 * b, final, 1, bias=True)
        self.inner3 = nn.Conv2d(b, final, 1, bias=True)
        self.out2 = nn.Conv2d(final, 4 * b, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(final, 2 * b, 3, padding=1, bias=False)
        self.out4 = nn.Conv2d(final, b, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        conv3 = self.conv3(conv2)

        intra = conv3
        out1 = self.out1(intra)
        intra = _up2(intra) + self.inner1(conv2)
        out2 = self.out2(intra)
        intra = _up2(intra) + self.inner2(conv1)
        out3 = self.out3(intra)
        intra = _up2(intra) + self.inner3(conv0)
        out4 = self.out4(intra)
        return {"stage1": out1, "stage2": out2, "stage3": out3, "stage4": out4}
