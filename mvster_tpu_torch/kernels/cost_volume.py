"""Multi-view cost volume: warp, correlate, fuse views (counterpart of mvster_tpu.kernels.cost_volume).

The plain PyTorch formulation follows the JAX package's XLA path: an
unrolled loop over source views that accumulates the attention-weighted
correlation online (a running weighted sum and a running weight that
starts at 1e-8), so peak memory is one warped volume, not one per view.

Two routes, as the JAX package's impl="pallas" / impl="xla":

  impl="fused"  (eval) `build_cost_volume(group_cor=True)` runs the fused
                kernel of kernels/warp_correlate.py (K1) on a CUDA tensor,
                the plain formulation below on a CPU tensor;
  impl="warp"   (training, differentiable) the per-view formulation below
                with the warp through kernels/warp_vjp.grid_sample_zeros_vjp:
                K2 gathers, K3 scatters the gradient back to the source
                features; the coordinates are detached, as in the JAX package.

Layouts are channels-last: features (B, H, W, C), hypotheses (B, D, H, W),
volume (B, D, H, W, G) or (B, D, H, W, C).  `row0` places the reference
rows in the image (a band of rows starting there, dist/spatial.py); the
source features may then have a size of their own (B, Hs, Ws, C).
`sg_warp` (MVS4NetConfig.sg_cuts "warp") detaches the warped source
features on every route.  The plain formulation keeps its
inputs' dtype: float32 in the model, float64 where a test wants an exact
reference.
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
    row0: int = 0,
) -> torch.Tensor:
    """Plane-sweep warp one source view (B, Hs, Ws, C) into the reference
    frustum at hypotheses (B, D, Hr, Wr), reference rows from row0 ->
    (B, D, Hr, Wr, C)."""
    x, y = plane_sweep_coords(src_proj, ref_proj, depth_hypo, row0)
    return grid_sample_zeros(src_feat, x, y)


def warp_src_feature_vjp(
    src_feat: torch.Tensor,
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_hypo: torch.Tensor,
    row0: int = 0,
) -> torch.Tensor:
    """warp_src_feature for training: K2 forward, K3 backward on a card.

    The coordinates are detached, so the zero-coordinate-gradient contract
    of grid_sample_zeros_vjp holds whatever the caller passes (MVSTER
    detaches the hypotheses between stages and the cameras are constants).
    """
    from mvster_tpu_torch.kernels.warp_vjp import grid_sample_zeros_vjp

    x, y = plane_sweep_coords(src_proj, ref_proj, depth_hypo, row0)
    return grid_sample_zeros_vjp(src_feat.contiguous(), x.detach(), y.detach())


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
    score = torch.sum(cor_feat, dim=-1)
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
    warp=warp_src_feature,
    sg_warp: bool = False,
    row0: int = 0,
) -> torch.Tensor:
    """The plain formulation: per-view warp, correlate, weight, accumulate;
    `warp` is warp_src_feature or, for training, warp_src_feature_vjp."""
    c = ref_feat.shape[-1]
    weight_sum = torch.tensor(1e-8, dtype=ref_feat.dtype, device=ref_feat.device)
    feats_sum = torch.tensor(0.0, dtype=ref_feat.dtype, device=ref_feat.device)
    for v in range(len(src_feats)):
        warped = warp(src_feats[v], src_projs[v], ref_proj, depth_hypo, row0)
        if sg_warp:
            warped = warped.detach()
        cor = correlate(warped, ref_feat, group_cor, group_dim)
        w = view_weight(cor, c, attn_temp, attn_fuse_d)
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
    impl: str = "fused",
    with_fallbacks: bool = False,
    sg_warp: bool = False,
    row0: int = 0,
):
    """Fused multi-view cost volume with online cross-view normalisation.

    ref_feat (B, H, W, C), the reference rows row0 .. row0 + H - 1;
    src_feats (V, B, Hs, Ws, C) or V tensors (B, Hs, Ws, C); ref_proj
    (B, 4, 4); src_projs (V, B, 4, 4) or V tensors (B, 4, 4); depth_hypo
    (B, D, H, W).  impl: "fused" (eval, K1) or "warp" (training,
    differentiable: K2/K3 per source view).  Returns (B, D, H, W, G) with
    group_cor, else (B, D, H, W, C); with_fallbacks also returns the JAX
    package's fallback count, which is always 0 here (no path falls back).
    """
    if impl not in ("fused", "warp"):
        raise ValueError(f"impl must be 'fused' or 'warp', got {impl!r}")
    if impl == "warp":
        out = plain_cost_volume(
            ref_feat, src_feats, ref_proj, src_projs, depth_hypo,
            group_cor=group_cor, group_dim=group_dim, attn_temp=attn_temp,
            attn_fuse_d=attn_fuse_d, warp=warp_src_feature_vjp, sg_warp=sg_warp,
            row0=row0,
        )
    elif group_cor:
        from mvster_tpu_torch.kernels.warp_correlate import fused_cost_volume

        if not isinstance(src_feats, torch.Tensor):
            src_feats = torch.stack(list(src_feats))
        if not isinstance(src_projs, torch.Tensor):
            src_projs = torch.stack(list(src_projs))
        if sg_warp:  # the warp reads only the source features
            src_feats = src_feats.detach()
        out = fused_cost_volume(
            ref_feat.contiguous(), src_feats.contiguous(), ref_proj,
            src_projs, depth_hypo.contiguous(), group_dim, attn_temp,
            attn_fuse_d, row0,
        )
    else:
        # The squared-difference volume has no kernel on any device, as in
        # the JAX package (its Pallas path requires group_cor): this plain
        # formulation is the implementation, not a fallback.
        out = plain_cost_volume(
            ref_feat, src_feats, ref_proj, src_projs, depth_hypo,
            group_cor=False, group_dim=group_dim, attn_temp=attn_temp,
            attn_fuse_d=attn_fuse_d, sg_warp=sg_warp, row0=row0,
        )
    return (out, 0) if with_fallbacks else out
