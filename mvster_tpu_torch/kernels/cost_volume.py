"""Multi-view cost volume: warp, correlate, fuse views (counterpart of mvster_tpu.kernels.cost_volume).

The plain PyTorch formulation follows the JAX package's XLA path: an
unrolled loop over source views that accumulates the attention-weighted
correlation online (a running weighted sum and a running weight that
starts at 1e-8), so peak memory is one warped volume, not one per view.

`build_cost_volume(group_cor=True)` on a CUDA tensor runs the fused CUDA
kernel of kernels/warp_correlate.py; on a CPU tensor it runs the plain
formulation below.  Layouts are channels-last: features (B, H, W, C),
hypotheses (B, D, H, W), volume (B, D, H, W, G) or (B, D, H, W, C).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from mvster_tpu_torch.core.geometry import plane_sweep_coords
from mvster_tpu_torch.core.sampling import grid_sample_zeros


def warp_src_feature(
    src_feat: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_hypo: torch.Tensor,
) -> torch.Tensor:
    """Plane-sweep warp one source view (B, H, W, C) into the reference
    frustum at hypotheses (B, D, Hr, Wr) -> (B, D, Hr, Wr, C)."""
    x, y = plane_sweep_coords(src_proj, ref_proj, depth_hypo)
    return grid_sample_zeros(src_feat, x, y)


def correlate(
    warped: torch.Tensor,
    ref_feat: torch.Tensor,
    group_cor: bool,
    group_dim: int,
) -> torch.Tensor:
    """Group correlation (mean over C/G sub-channels of warped * ref) ->
    (B, D, H, W, G), or the squared difference -> (B, D, H, W, C)."""
    if group_cor:
        b, d, h, w, c = warped.shape
        sub = c // group_dim
        wg = warped.reshape(b, d, h, w, group_dim, sub)
        rg = ref_feat.reshape(b, 1, h, w, group_dim, sub)
        return torch.mean(wg * rg, dim=-1)
    diff = ref_feat[:, None] - warped
    return diff * diff


def view_weight(
    cor_feat: torch.Tensor,
    feat_channels: int,
    attn_temp: float,
    attn_fuse_d: bool,
) -> torch.Tensor:
    """One source view's attention weight: softmax over depth of the
    channel-summed correlation, scaled 1/sqrt(C) -> (B, D, H, W); or, when
    not attn_fuse_d, the per-pixel max of that softmax -> (B, H, W)."""
    score = torch.sum(cor_feat, dim=-1).float()
    if attn_fuse_d:
        return torch.softmax(score / attn_temp, dim=1) / math.sqrt(feat_channels)
    return torch.max(torch.softmax(score, dim=1), dim=1).values


def plain_cost_volume(
    ref_feat: torch.Tensor,
    src_feats: Sequence[torch.Tensor] | torch.Tensor,
    ref_proj: torch.Tensor,
    src_projs: Sequence[torch.Tensor] | torch.Tensor,
    depth_hypo: torch.Tensor,
    *,
    group_cor: bool,
    group_dim: int,
    attn_temp: float,
    attn_fuse_d: bool,
) -> torch.Tensor:
    """The plain formulation: per-view warp, correlate, weight, accumulate."""
    c = ref_feat.shape[-1]
    weight_sum = torch.tensor(1e-8, dtype=torch.float32, device=ref_feat.device)
    feats_sum = torch.tensor(0.0, dtype=torch.float32, device=ref_feat.device)
    for v in range(len(src_feats)):
        warped = warp_src_feature(src_feats[v], src_projs[v], ref_proj, depth_hypo)
        cor = correlate(warped, ref_feat, group_cor, group_dim)
        w = view_weight(cor, c, attn_temp, attn_fuse_d)
        cor = cor.float()
        weight_sum = weight_sum + w
        if attn_fuse_d:
            feats_sum = feats_sum + w[..., None] * cor
        else:
            feats_sum = feats_sum + w[:, None, :, :, None] * cor
    if attn_fuse_d:
        return feats_sum / weight_sum[..., None]
    return feats_sum / weight_sum[:, None, :, :, None]


def build_cost_volume(
    ref_feat: torch.Tensor,
    src_feats: Sequence[torch.Tensor] | torch.Tensor,
    ref_proj: torch.Tensor,
    src_projs: Sequence[torch.Tensor] | torch.Tensor,
    depth_hypo: torch.Tensor,
    *,
    group_cor: bool = True,
    group_dim: int = 8,
    attn_temp: float = 2.0,
    attn_fuse_d: bool = True,
    with_fallbacks: bool = False,
):
    """Fused multi-view cost volume with online cross-view normalisation.

    ref_feat (B, H, W, C); src_feats (V, B, H, W, C) or V tensors
    (B, H, W, C); ref_proj (B, 4, 4); src_projs (V, B, 4, 4) or V tensors
    (B, 4, 4); depth_hypo (B, D, H, W).  Returns (B, D, H, W, G) with
    group_cor, else (B, D, H, W, C); with_fallbacks also returns the JAX
    package's fallback count, which is always 0 here (no path falls back).
    """
    if group_cor:
        from mvster_tpu_torch.kernels.warp_correlate import fused_cost_volume

        if not isinstance(src_feats, torch.Tensor):
            src_feats = torch.stack(list(src_feats))
        if not isinstance(src_projs, torch.Tensor):
            src_projs = torch.stack(list(src_projs))
        out = fused_cost_volume(
            ref_feat.contiguous(), src_feats.contiguous(), ref_proj,
            src_projs, depth_hypo.contiguous(), group_dim, attn_temp,
            attn_fuse_d,
        )
    else:
        # The squared-difference volume has no kernel on any device, as in
        # the JAX package (its Pallas path requires group_cor): this plain
        # formulation is the implementation, not a fallback.
        out = plain_cost_volume(
            ref_feat, src_feats, ref_proj, src_projs, depth_hypo,
            group_cor=False, group_dim=group_dim, attn_temp=attn_temp,
            attn_fuse_d=attn_fuse_d,
        )
    return (out, 0) if with_fallbacks else out
