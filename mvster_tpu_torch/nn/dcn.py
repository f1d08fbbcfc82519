"""Modulated deformable 3x3 convolution (counterpart of mvster_tpu.nn.dcn).

The JAX package computes it with gathers and one dense contraction, no
Pallas kernel: offsets and modulation from two 3x3 convs with bias
(`p_conv`, laid out [dy x n | dx x n], and `m_conv`, a sigmoid),
border-clamped bilinear taps of the zero-padded input, and the dense
(n, C, O) tap kernel with n = ki * k + kj.  The port runs the two convs
and hands the rest to kernels/deform_conv.deform_conv: its plain version
(the same gathers and contraction) on CPU tensors, K7 on the card (its
backward recomputes the plain version).

Names: DeformConvBlock is the reference's NA_DCN sequential, so its norm is
`feature.dcn{n}.0.*` and the tap kernel `feature.dcn{n}.2.weight` in the
torch conv layout (O, C, k, k).  The reference's external DeformConvPack
has no offset or modulation convs of these names; the port names them
`feature.dcn{n}.2.p_conv.*` and `feature.dcn{n}.2.m_conv.*`.
"""

from __future__ import annotations

import torch
from torch import nn

from mvster_tpu_torch.kernels import deform_conv
from mvster_tpu_torch.nn.blocks import BatchNorm2d


class DeformConv2d(nn.Module):
    """(B, C, H, W) -> (B, O, H, W): modulated deformable k x k conv, stride 1,
    padding (k - 1) / 2, no bias.

    On a band of image rows `row_band` is the band (dist/spatial.RowBand,
    set while the step runs): the offsets are the band's, and the taps,
    which may reach any row, sample the whole map gathered from the bands
    at the band's global rows."""

    row_band = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.p_conv = nn.Conv2d(in_channels, 2 * k * k, 3, padding=1, bias=True)
        self.m_conv = nn.Conv2d(in_channels, k * k, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        offsets = self.p_conv(x)
        mask = self.m_conv(x)
        whole, row0 = x, 0
        if self.row_band is not None:
            whole, row0 = self.row_band.gather(x), self.row_band.row0(x.shape[-2])
        return deform_conv.deform_conv(whole, offsets, mask, self.weight, row0)


class DeformConvBlock(nn.Sequential):
    """BatchNorm2d -> ReLU -> DeformConv2d (the reference's NA_DCN)."""

    def __init__(self, channels: int):
        super().__init__(BatchNorm2d(channels, eps=1e-5, momentum=0.1), nn.ReLU(),
                         DeformConv2d(channels, channels))
