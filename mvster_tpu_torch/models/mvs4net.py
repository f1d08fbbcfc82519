"""MVS4Net: the 4-stage coarse-to-fine cascade (counterpart of mvster_tpu.models.mvs4net).

Per stage: depth hypotheses (inverse-range init, or a schedule around the
previous stage), the multi-view cost volume, Reg2d, a softmax over depth,
winner-take-all depth (the first maximum wins a tie) and the
max-probability confidence, upsampled to full resolution.  Views are folded
into the batch for the FPN, as in the JAX package, so in training its
BatchNorm statistics are taken over B*V images.

In eval the cost volume is the fused kernel K1 (one launch per stage); in
training it is the differentiable route, K2 gathers and K3 gradients per
source view (kernels/cost_volume.py), and with config.mono the monocular
decoder runs too.

Module names follow the reference checkpoint's state-dict grammar
(`feature.*`, `reg.{s}.*`), so `load_state_dict(strict=True)` takes both
tools.weights.state_dict_from_jax(...) and a released MVSTER checkpoint.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from mvster_tpu_torch.config import MVS4NetConfig
from mvster_tpu_torch.core.geometry import compose_projection
from mvster_tpu_torch.core.hypothesis import (
    init_inverse_range,
    init_range,
    schedule_inverse_range,
    schedule_range,
)
from mvster_tpu_torch.core.sampling import resize_bilinear_align_corners
from mvster_tpu_torch.kernels.cost_volume import build_cost_volume
from mvster_tpu_torch.nn.fpn import FPN4
from mvster_tpu_torch.nn.mono import MonoDepthDecoder
from mvster_tpu_torch.nn.reg import Reg2d

__all__ = ["MVS4Net", "MVS4NetConfig"]


class MVS4Net(nn.Module):
    """4-stage cascaded MVS depth network.

    forward(imgs, proj_matrices, depth_values):
      imgs: (B, V, H, W, 3) images in [0, 1], view 0 the reference; H and W
        multiples of 64.
      proj_matrices: {"stage1".."stage4": (B, V, 2, 4, 4)}.
      depth_values: (B, K), [:, 0] = dmin and [:, -1] = dmax.
    Returns {"stage{i}": {depth, photometric_confidence, hypo_depth,
    attn_weight, warp_fallbacks[, inverse_min_depth, inverse_max_depth]
    [, mono_feat][, mono_depth]}} with the final stage's fields also at the
    top level; mono_depth (stages 2-4) only in training with config.mono.
    """

    def __init__(self, config: MVS4NetConfig):
        super().__init__()
        missing = config.unsupported()
        if missing:
            raise NotImplementedError(
                f"the PyTorch port does not run {', '.join(missing)} yet"
            )
        self.config = config
        self.feature = FPN4(config.fpn_base_channel)
        in_channels = (config.group_cor_dim if config.group_cor
                       else self.feature.out_channels)
        self.reg = nn.ModuleList(
            Reg2d(in_channels[s], config.reg_channel)
            for s in range(config.num_stage)
        )
        if config.mono:
            self.mono_depth_decoder = MonoDepthDecoder(self.feature.out_channels)

    def forward(self, imgs: torch.Tensor, proj_matrices: dict[str, torch.Tensor],
                depth_values: torch.Tensor) -> dict[str, Any]:
        cfg = self.config
        b, v, h, w, _ = imgs.shape
        if h % 64 or w % 64:
            raise ValueError(f"H and W must be multiples of 64, got {h}x{w}")
        k = depth_values.shape[1]
        depth_interval = (depth_values[:, -1] - depth_values[:, 0]) / k

        flat = imgs.reshape(b * v, h, w, imgs.shape[-1]).permute(0, 3, 1, 2)
        feats_flat = self.feature(flat.contiguous())
        features = {  # stage -> (B, V, Hs, Ws, C), channels-last
            key: f.permute(0, 2, 3, 1).reshape(b, v, *f.shape[2:], f.shape[1])
            for key, f in feats_flat.items()
        }

        outputs: dict[str, Any] = {}
        prev: dict[str, Any] = {}
        for stage_idx in range(cfg.num_stage):
            stage_key = f"stage{stage_idx + 1}"
            feat_stage = features[stage_key]
            hs, ws = feat_stage.shape[2], feat_stage.shape[3]
            ndepth = cfg.stage_splits[stage_idx]
            if stage_idx == 0:
                init = init_inverse_range if cfg.inverse_depth else init_range
                depth_hypo = init(depth_values, ndepth, hs, ws)
            elif cfg.inverse_depth:
                depth_hypo = schedule_inverse_range(
                    prev["inverse_min_depth"].detach(),
                    prev["inverse_max_depth"].detach(), ndepth, hs, ws,
                )
            else:
                depth_hypo = schedule_range(
                    prev["depth"].detach(), ndepth,
                    cfg.depth_interals_ratio[stage_idx] * depth_interval, hs, ws,
                )
            prev = self._stage(feat_stage, proj_matrices[stage_key],
                               depth_hypo, stage_idx)
            outputs[stage_key] = prev
        outputs.update(prev)

        if cfg.mono and self.training:
            mono_depths = self.mono_depth_decoder(
                {key: outputs[key]["mono_feat"] for key in features},
                depth_values[:, 0], depth_values[:, 1],
            )
            for key, depth in mono_depths.items():
                outputs[key]["mono_depth"] = depth
        return outputs

    def _stage(self, feat_stage, projs, depth_hypo, stage_idx):
        cfg = self.config
        ref_feat = feat_stage[:, 0].contiguous()
        src_feats = feat_stage[:, 1:].transpose(0, 1).contiguous()  # (V-1, B, ...)
        composed = compose_projection(projs)  # (B, V, 4, 4)
        ref_proj = composed[:, 0]
        src_projs = composed[:, 1:].transpose(0, 1)

        cor, warp_fallbacks = build_cost_volume(
            ref_feat, src_feats, ref_proj, src_projs, depth_hypo,
            group_cor=cfg.group_cor, group_dim=cfg.group_cor_dim[stage_idx],
            attn_temp=cfg.attn_temp, attn_fuse_d=cfg.attn_fuse_d,
            impl="warp" if self.training else "fused", with_fallbacks=True,
        )  # (B, D, H, W, G|C)
        logits = self.reg[stage_idx](cor.permute(0, 4, 1, 2, 3).contiguous())
        attn_weight = torch.softmax(logits, dim=1)  # (B, D, H, W)

        # winner-take-all depth; torch.argmax returns the first maximum
        idx = torch.argmax(attn_weight, dim=1, keepdim=True)
        depth = torch.gather(depth_hypo, 1, idx)[:, 0]  # (B, H, W)

        conf = torch.max(attn_weight, dim=1).values
        up = 2 ** (3 - stage_idx)
        if up > 1:
            conf = resize_bilinear_align_corners(
                conf[..., None], conf.shape[1] * up, conf.shape[2] * up
            )[..., 0]

        ret = {
            "depth": depth,
            "photometric_confidence": conf,
            "hypo_depth": depth_hypo,
            "attn_weight": attn_weight,
            "warp_fallbacks": warp_fallbacks,
        }
        if cfg.inverse_depth:
            itv = 1.0 / depth_hypo[:, 2] - 1.0 / depth_hypo[:, 1]
            split = cfg.depth_interals_ratio[stage_idx]
            ret["inverse_min_depth"] = 1.0 / depth + split * itv
            ret["inverse_max_depth"] = 1.0 / depth - split * itv
        if cfg.mono:
            ret["mono_feat"] = ref_feat
        return ret
