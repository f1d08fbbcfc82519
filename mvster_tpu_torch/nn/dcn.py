"""Modulated deformable 3x3 convolution, plain PyTorch (counterpart of mvster_tpu.nn.dcn).

The JAX package computes it with gathers and one dense contraction, no
Pallas kernel, and so does the port: offsets and modulation from two 3x3
convs with bias (`p_conv`, laid out [dy x n | dx x n], and `m_conv`, a
sigmoid), border-clamped bilinear taps of the zero-padded input, and the
dense (n, C, O) tap kernel with n = ki * k + kj.

Names: DeformConvBlock is the reference's NA_DCN sequential, so its norm is
`feature.dcn{n}.0.*` and the tap kernel `feature.dcn{n}.2.weight` in the
torch conv layout (O, C, k, k).  The reference's external DeformConvPack
has no offset or modulation convs of these names; the port names them
`feature.dcn{n}.2.p_conv.*` and `feature.dcn{n}.2.m_conv.*`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvster_tpu_torch.nn.blocks import BatchNorm2d


def _clamped_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C); x, y (B, ...) pixel coordinates, clamped to the
    image -> (B, ..., C)."""
    b, h, w, c = img.shape
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = x0.long().clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    flat = img.reshape(b, h * w, c)
    bidx = torch.arange(b, device=img.device).view(b, *([1] * (x.dim() - 1)))

    def tap(yi, xi, weight):
        return flat[bidx, yi * w + xi] * weight[..., None]

    return (tap(y0i, x0i, (1 - wy) * (1 - wx)) + tap(y0i, x1i, (1 - wy) * wx)
            + tap(y1i, x0i, wy * (1 - wx)) + tap(y1i, x1i, wy * wx))


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
        k = self.kernel_size
        n, pad = k * k, (k - 1) // 2
        b, c, h, w = x.shape
        offsets = self.p_conv(x).permute(0, 2, 3, 1)  # (B, H, W, 2n)
        mod = torch.sigmoid(self.m_conv(x)).permute(0, 2, 3, 1)  # (B, H, W, n)
        whole, row0 = x, 0
        if self.row_band is not None:
            whole, row0 = self.row_band.gather(x), self.row_band.row0(h)
        x_pad = F.pad(whole, (pad, pad, pad, pad)).permute(0, 2, 3, 1)
        ar = lambda m: torch.arange(m, dtype=x.dtype, device=x.device)  # noqa: E731
        taps = ar(k) - pad
        ty, tx = taps.repeat_interleave(k), taps.repeat(k)  # (n,) as n = ki * k + kj
        py = (ar(h) + row0 + pad)[:, None, None] + ty + offsets[..., :n]  # (B, H, W, n)
        px = (ar(w) + pad)[None, :, None] + tx + offsets[..., n:]
        samples = _clamped_bilinear(x_pad, px, py) * mod[..., None]  # (B, H, W, n, C)
        kernel = self.weight.reshape(-1, c, n).permute(2, 1, 0)  # (n, C, O)
        out = samples.reshape(b * h * w, n * c) @ kernel.reshape(n * c, -1)
        return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


class DeformConvBlock(nn.Sequential):
    """BatchNorm2d -> ReLU -> DeformConv2d (the reference's NA_DCN)."""

    def __init__(self, channels: int):
        super().__init__(BatchNorm2d(channels, eps=1e-5, momentum=0.1), nn.ReLU(),
                         DeformConv2d(channels, channels))
