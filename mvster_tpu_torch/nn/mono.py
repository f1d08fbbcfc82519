"""Monocular-depth auxiliary decoder (counterpart of mvster_tpu.nn.mono.MonoDepthDecoder).

For each consecutive stage pair (i, i+1) it runs a ConvBlock2d on the
coarse reference feature, upsamples it 2x (nearest), concatenates the finer
feature, predicts a sigmoid disparity with a 3x3 conv (with bias) and maps
it into [1/dmax, 1/dmin].  Training only.  Names follow the reference
checkpoint: `convblocks.{i}.*` and `conv3x3.{i}.*`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mvster_tpu_torch.core.sampling import upsample_nearest_2x
from mvster_tpu_torch.nn.blocks import ConvBlock2d

_OUT_CHANNELS = (32, 16, 8)


class MonoDepthDecoder(nn.Module):
    """feat_channels: the FPN's channels for stage1..stage4, e.g. (64, 32, 16, 8)."""

    def __init__(self, feat_channels: Sequence[int]):
        super().__init__()
        self.convblocks = nn.ModuleList(
            ConvBlock2d(feat_channels[i], _OUT_CHANNELS[i], 3, 1, 1)
            for i in range(3)
        )
        self.conv3x3 = nn.ModuleList(
            nn.Conv2d(_OUT_CHANNELS[i] + feat_channels[i + 1], 1, 3, padding=1,
                      bias=True)
            for i in range(3)
        )

    def forward(self, mono_feats: dict[str, torch.Tensor], d_min: torch.Tensor,
                d_max: torch.Tensor) -> dict[str, torch.Tensor]:
        """mono_feats: stage name -> (B, H, W, C) reference feature;
        d_min, d_max (B,).  Returns {"stage2".."stage4": (B, H, W) depth}."""
        min_disp = (1.0 / d_max)[:, None, None]
        max_disp = (1.0 / d_min)[:, None, None]
        out = {}
        for i in range(3):
            small = mono_feats[f"stage{i + 1}"].permute(0, 3, 1, 2)
            small = self.convblocks[i](small).permute(0, 2, 3, 1)
            small = upsample_nearest_2x(small)
            large = mono_feats[f"stage{i + 2}"]
            feat = torch.cat([small, large], dim=-1).permute(0, 3, 1, 2)
            disp = torch.sigmoid(self.conv3x3[i](feat))[:, 0]  # (B, H, W)
            out[f"stage{i + 2}"] = 1.0 / (min_disp + (max_disp - min_disp) * disp)
        return out
