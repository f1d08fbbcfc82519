"""Resampling primitives (counterpart of mvster_tpu.core.sampling).

`bilinear_sample` is a plain 4-tap gather on raw pixel coordinates, with
one zero-padding mask per tap and the taps summed in the order y0x0, y0x1,
y1x0, y1x1 — the JAX package's formulation.  It equals
`F.grid_sample(mode="bilinear", padding_mode="zeros", align_corners=True)`
in exact arithmetic, but grid_sample's normalise/un-normalise round trip
moves the coordinates by ~1e-5 px, so it is not used.

The align-corners resizes are `F.interpolate(..., align_corners=True)`.
Layouts are channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at pixel coordinates x, y (same shape) -> (*x.shape, C)."""
    return grid_sample_zeros(img[None], x[None], y[None])[0]


def bilinear_taps(x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """The four taps of a zero-padded bilinear sample at pixel coordinates
    x, y of an h x w image, in the order y0x0, y0x1, y1x0, y1x1: a list of
    (flat in-image index, weight * validity), each shaped like x.

    A tap outside the image reads a clamped in-image pixel with weight 0.
    """
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    # clamp before the integer cast: a far-off coordinate (z near 0) would
    # overflow it; the clamped index stays out of the image, so stays invalid
    x0i = x0.clamp(-2, w + 1).long()
    y0i = y0.clamp(-2, h + 1).long()
    taps = []
    for yi, xi, weight in ((y0i, x0i, (1.0 - wy) * (1.0 - wx)),
                           (y0i, x0i + 1, (1.0 - wy) * wx),
                           (y0i + 1, x0i, wy * (1.0 - wx)),
                           (y0i + 1, x0i + 1, wy * wx)):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        taps.append((yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1), weight * valid))
    return taps


def grid_sample_zeros(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched bilinear sample: img (B, H, W, C); x, y (B, ...) -> (B, ..., C).

    Each tap outside the image contributes zero, so a sample that straddles
    the border is partly zeroed.
    """
    b, h, w, c = img.shape
    out_shape = x.shape + (c,)
    flat_img = img.reshape(b, h * w, c)
    bidx = torch.arange(b, device=img.device).view(b, 1)
    (f0, w0), (f1, w1), (f2, w2), (f3, w3) = bilinear_taps(
        x.reshape(b, -1), y.reshape(b, -1), h, w)
    out = (
        flat_img[bidx, f0] * w0[..., None]
        + flat_img[bidx, f1] * w1[..., None]
        + flat_img[bidx, f2] * w2[..., None]
        + flat_img[bidx, f3] * w3[..., None]
    )
    return out.reshape(out_shape)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C), align_corners=True bilinear."""
    h, w, c = x.shape[-3:]
    if (h, w) == (out_h, out_w):
        return x
    lead = x.shape[:-3]
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(out_h, out_w), mode="bilinear",
                        align_corners=True)
    return out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., fH, fW, C) by pixel replication, as
    F.interpolate(scale_factor=factor, mode="nearest") does."""
    return x.repeat_interleave(factor, dim=-3).repeat_interleave(factor, dim=-2)


def max_pool2d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """(..., H, W, C) max pool without padding, as F.max_pool2d(padding=0)."""
    h, w, c = x.shape[-3:]
    lead = x.shape[:-3]
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.max_pool2d(nchw, window, stride)
    return out.permute(0, 2, 3, 1).reshape(*lead, *out.shape[2:], c)


def resize_trilinear_align_corners(
    x: torch.Tensor, out_d: int, out_h: int, out_w: int
) -> torch.Tensor:
    """(..., D, H, W) -> (..., out_d, out_h, out_w), align_corners trilinear."""
    d, h, w = x.shape[-3:]
    lead = x.shape[:-3]
    out = F.interpolate(x.reshape(-1, 1, d, h, w), size=(out_d, out_h, out_w),
                        mode="trilinear", align_corners=True)
    return out.reshape(*lead, out_d, out_h, out_w)
