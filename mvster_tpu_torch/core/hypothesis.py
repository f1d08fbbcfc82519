"""Depth-hypothesis samplers for the cascade (counterpart of mvster_tpu.core.hypothesis).

Stage 1 spreads D hypotheses over the scene range, uniform in depth or in
inverse depth; later stages narrow the range around the previous stage's
prediction and upsample the (B, D, H, W) volume 2x with align-corners
trilinear interpolation (`resize`; dist/spatial.py gives one that maps a
band's rows to their global coordinates).
"""

from __future__ import annotations

import torch

from mvster_tpu_torch.core.sampling import resize_trilinear_align_corners


def init_range(depth_values: torch.Tensor, ndepths: int, h: int, w: int) -> torch.Tensor:
    """Uniform-in-depth hypotheses over [dmin, dmax]; depth_values (B, K) -> (B, D, H, W)."""
    dmin = depth_values[:, 0]
    dmax = depth_values[:, -1]
    interval = (dmax - dmin) / (ndepths - 1)
    steps = torch.arange(ndepths, device=depth_values.device, dtype=depth_values.dtype)
    samples = dmin[:, None] + steps[None, :] * interval[:, None]  # (B, D)
    return samples[:, :, None, None].expand(-1, -1, h, w).contiguous()


def init_inverse_range(
    depth_values: torch.Tensor, ndepths: int, h: int, w: int
) -> torch.Tensor:
    """Uniform-in-inverse-depth hypotheses; index 0 is the far plane (dmax)."""
    inv_min = 1.0 / depth_values[:, 0]
    inv_max = 1.0 / depth_values[:, -1]
    itv = torch.arange(ndepths, device=depth_values.device,
                       dtype=depth_values.dtype) / (ndepths - 1)
    inv_hypo = inv_max[:, None] + (inv_min - inv_max)[:, None] * itv[None, :]
    hypo = 1.0 / inv_hypo  # (B, D)
    return hypo[:, :, None, None].expand(-1, -1, h, w).contiguous()


def schedule_inverse_range(
    inverse_min_depth: torch.Tensor,
    inverse_max_depth: torch.Tensor,
    ndepths: int,
    h: int,
    w: int,
    resize=resize_trilinear_align_corners,
) -> torch.Tensor:
    """Inverse-depth hypotheses around the previous stage's (B, H/2, W/2) bounds."""
    itv = torch.arange(ndepths, device=inverse_min_depth.device,
                       dtype=inverse_min_depth.dtype) / (ndepths - 1)
    inv_hypo = (
        inverse_max_depth[:, None, :, :]
        + (inverse_min_depth - inverse_max_depth)[:, None, :, :] * itv[None, :, None, None]
    )  # (B, D, H/2, W/2)
    inv_hypo = resize(inv_hypo, ndepths, h, w)
    return 1.0 / inv_hypo


def schedule_range(
    cur_depth: torch.Tensor,
    ndepths: int,
    depth_interval_pixel: torch.Tensor,
    h: int,
    w: int,
    resize=resize_trilinear_align_corners,
) -> torch.Tensor:
    """Uniform-in-depth hypotheses around the previous stage's (B, H/2, W/2) depth."""
    half = ndepths / 2 * depth_interval_pixel[:, None, None]
    dmin = cur_depth - half
    dmax = cur_depth + half
    interval = (dmax - dmin) / (ndepths - 1)
    steps = torch.arange(ndepths, device=cur_depth.device, dtype=cur_depth.dtype)
    samples = dmin[:, None, :, :] + steps[None, :, None, None] * interval[:, None, :, :]
    return resize(samples, ndepths, h, w)
