"""MVS4Net: the coarse-to-fine cascade (counterpart of mvster_tpu.models.mvs4net).

Per stage: depth hypotheses (inverse-range init, or a schedule around the
previous stage), the multi-view cost volume, an optional depth positional
encoding (pos_enc 1 sine, 2 learned), the regulariser (Reg2d with its
agg_type, or Reg3d), a softmax over depth, winner-take-all depth (the
first maximum wins a tie) and the max-probability confidence, upsampled
to full resolution.  Views are folded into the batch for the backbone
(arch_mode fpn, convnext or convnext4, optionally with DCN heads), as in
the JAX package, so in training its BatchNorm statistics are taken over
B*V images; with asff each stage's features are fused per view.

In eval the cost volume is the fused kernel K1 (one launch per stage); in
training it is the differentiable route, K2 gathers and K3 gradients per
source view (kernels/cost_volume.py), and with config.mono the monocular
decoder runs too.

config.sg_cuts, the JAX package's training-only measurement hook, detaches
at named boundaries, with the forward unchanged: "fpn" the pyramid's
features, "warp" every warped source feature inside the cost volume (so
K3 never runs), "cost_volume" the volume, "logits" Reg2d's output and
"mono" the monocular depths.  `return_debug` adds each stage's features
and composed projections for tools/test.py's --vis_ETA / --vis_mono dumps.
`resize` and `gather_sources` run the eval cascade on one band of image
rows (dist/spatial.py).  With compute_dtype "bfloat16" the FPN4 backbone and
Reg2d run their convolutions in bfloat16 where the JAX package does; the
features are cast to float32 before the cost volume, so no kernel sees
bfloat16, and softmax, argmax, geometry and losses stay float32.

Module names follow the reference checkpoint's state-dict grammar
(`feature.*`, `reg.{s}.*`, `asff.{l}.*`, `pos_enc_func.{s}`), so
`load_state_dict(strict=True)` takes both
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
from mvster_tpu_torch.core.sampling import (
    resize_bilinear_align_corners,
    resize_trilinear_align_corners,
)
from mvster_tpu_torch.kernels.cost_volume import build_cost_volume
from mvster_tpu_torch.nn.fpn import ASFF, FPN4, FPN4ConvNeXt, FPN4ConvNeXt4
from mvster_tpu_torch.nn.mono import MonoDepthDecoder
from mvster_tpu_torch.nn.posenc import pos_enc_learned, pos_enc_sine
from mvster_tpu_torch.nn.reg import Reg2d, Reg3d
from mvster_tpu_torch.utils.profiling import span

__all__ = ["MVS4Net", "MVS4NetConfig"]


class MVS4Net(nn.Module):
    """4-stage cascaded MVS depth network.

    forward(imgs, proj_matrices, depth_values):
      imgs: (B, V, H, W, 3) images in [0, 1], view 0 the reference; H and W
        multiples of 64.
      proj_matrices: {"stage1".."stage4": (B, V, 2, 4, 4)}.
      depth_values: (B, K), [:, 0] = dmin and [:, -1] = dmax.
      return_debug: also return each stage's debug_features (B, V, h, w, C)
        and debug_proj (B, V, 4, 4), as the JAX model's return_debug.
      resize: None, or the align-corners bilinear resize
        `resize(x, out_h, out_w)` of (..., H, W) maps that every upsampling
        of the cascade then uses (the FPN's 2x, the hypotheses', the
        confidence's).
      gather_sources: None, or `gather_sources(src) -> (whole, row0)`:
        the whole source feature maps (V-1, B, H, W, C) from the given
        ones, and the image row of the reference's first row.
      With both, imgs hold a band of image rows and every map of the
      cascade is the band's (dist/spatial.py gives both callables).
    Returns {"stage{i}": {depth, photometric_confidence, hypo_depth,
    attn_weight[, inverse_min_depth, inverse_max_depth]
    [, mono_feat][, mono_depth][, debug_features, debug_proj]}} with the
    final stage's fields also at the top level; mono_depth (stages 2-4)
    only in training with config.mono.
    """

    def __init__(self, config: MVS4NetConfig):
        super().__init__()
        self.config = config
        dtype = {"float32": None, "bfloat16": torch.bfloat16}[config.compute_dtype]
        b = config.fpn_base_channel
        if config.arch_mode == "fpn":
            self.feature = FPN4(b, dcn=config.dcn, dtype=dtype)
        elif config.arch_mode in ("convnext", "convnext4"):
            cls = FPN4ConvNeXt if config.arch_mode == "convnext" else FPN4ConvNeXt4
            self.feature = cls(b, dcn=config.dcn)
        else:
            raise ValueError(f"unknown arch_mode {config.arch_mode!r}")
        if config.asff:
            self.asff = nn.ModuleList(ASFF(level) for level in range(config.num_stage))
        in_channels = (config.group_cor_dim if config.group_cor
                       else self.feature.out_channels)
        if config.pos_enc == 2:
            self.pos_enc_func = nn.ParameterList(
                torch.zeros(in_channels[s], config.stage_splits[s])
                for s in range(config.num_stage))
        elif config.pos_enc not in (0, 1):
            raise ValueError(f"unknown pos_enc {config.pos_enc}")
        if config.reg_net == "reg2d":
            self.reg = nn.ModuleList(
                Reg2d(in_channels[s], config.reg_channel, config.agg_type, dtype)
                for s in range(config.num_stage))
        elif config.reg_net == "reg3d":
            self.reg = nn.ModuleList(
                Reg3d(in_channels[s], config.reg_channel, config.reg3d_down_size[s])
                for s in range(config.num_stage))
        else:
            raise ValueError(f"unknown reg_net {config.reg_net!r}")
        if config.mono:
            self.mono_depth_decoder = MonoDepthDecoder(self.feature.out_channels)

    def forward(self, imgs: torch.Tensor, proj_matrices: dict[str, torch.Tensor],
                depth_values: torch.Tensor, return_debug: bool = False,
                resize=None, gather_sources=None) -> dict[str, Any]:
        cfg = self.config
        b, v, h, w, _ = imgs.shape
        if h % 64 or w % 64:
            raise ValueError(f"H and W must be multiples of 64, got {h}x{w}")
        k = depth_values.shape[1]
        depth_interval = (depth_values[:, -1] - depth_values[:, 0]) / k

        flat = imgs.reshape(b * v, h, w, imgs.shape[-1]).permute(0, 3, 1, 2).contiguous()
        with span("mvs.fpn"):
            feats_flat = (self.feature(flat) if resize is None
                          else self.feature(flat, resize=resize))
        features = {  # stage -> (B, V, Hs, Ws, C), channels-last
            key: f.permute(0, 2, 3, 1).reshape(b, v, *f.shape[2:], f.shape[1])
            for key, f in feats_flat.items()
        }
        if "fpn" in cfg.sg_cuts:
            features = {key: f.detach() for key, f in features.items()}
        resize_hypo = (resize_trilinear_align_corners if resize is None
                       else lambda x, d, hs, ws: resize(x, hs, ws))

        outputs: dict[str, Any] = {}
        prev: dict[str, Any] = {}
        for stage_idx in range(cfg.num_stage):
            stage_key = f"stage{stage_idx + 1}"
            if cfg.asff:  # per view, as the JAX package calls it
                levels = [features[f"stage{i}"] for i in range(1, 5)]
                feat_stage = torch.stack([
                    self.asff[stage_idx](*(f[:, view] for f in levels))
                    for view in range(v)], dim=1)
            else:
                feat_stage = features[stage_key]
            hs, ws = feat_stage.shape[2], feat_stage.shape[3]
            ndepth = cfg.stage_splits[stage_idx]
            if stage_idx == 0:
                init = init_inverse_range if cfg.inverse_depth else init_range
                depth_hypo = init(depth_values, ndepth, hs, ws)
            elif cfg.inverse_depth:
                depth_hypo = schedule_inverse_range(
                    prev["inverse_min_depth"].detach(),
                    prev["inverse_max_depth"].detach(), ndepth, hs, ws, resize=resize_hypo,
                )
            else:
                depth_hypo = schedule_range(
                    prev["depth"].detach(), ndepth,
                    cfg.depth_interals_ratio[stage_idx] * depth_interval, hs, ws,
                    resize=resize_hypo,
                )
            prev = self._stage(feat_stage, proj_matrices[stage_key],
                               depth_hypo, stage_idx, resize, gather_sources)
            if return_debug:
                prev["debug_features"] = feat_stage
                prev["debug_proj"] = compose_projection(proj_matrices[stage_key])
            outputs[stage_key] = prev
        outputs.update(prev)

        if cfg.mono and self.training:
            mono_depths = self.mono_depth_decoder(
                {key: outputs[key]["mono_feat"] for key in features},
                depth_values[:, 0], depth_values[:, 1],
            )
            for key, depth in mono_depths.items():
                if "mono" in cfg.sg_cuts:
                    depth = depth.detach()
                outputs[key]["mono_depth"] = depth
        return outputs

    def _stage(self, feat_stage, projs, depth_hypo, stage_idx, resize=None,
               gather_sources=None):
        cfg = self.config
        # the kernels take float32: bfloat16 features are cast up, exactly
        feat_stage = feat_stage.to(depth_hypo.dtype)
        ref_feat = feat_stage[:, 0].contiguous()
        src_feats = feat_stage[:, 1:].transpose(0, 1).contiguous()  # (V-1, B, ...)
        row0 = 0
        if gather_sources is not None:  # the plane sweep reads any source row
            src_feats, row0 = gather_sources(src_feats)
        composed = compose_projection(projs)  # (B, V, 4, 4)
        ref_proj = composed[:, 0]
        src_projs = composed[:, 1:].transpose(0, 1)

        with span("mvs.cost_volume"):
            cor = build_cost_volume(
                ref_feat, src_feats, ref_proj, src_projs, depth_hypo,
                group_cor=cfg.group_cor, group_dim=cfg.group_cor_dim[stage_idx],
                attn_temp=cfg.attn_temp, attn_fuse_d=cfg.attn_fuse_d,
                impl="warp" if self.training else "fused",
                sg_warp="warp" in cfg.sg_cuts, row0=row0,
            )  # (B, D, H, W, G|C)
            if "cost_volume" in cfg.sg_cuts:
                cor = cor.detach()
            if cfg.pos_enc == 1:
                cor = pos_enc_sine(cor, depth_hypo)
            elif cfg.pos_enc == 2:
                cor = pos_enc_learned(cor, self.pos_enc_func[stage_idx])
        with span("mvs.reg"):
            logits = self.reg[stage_idx](cor.permute(0, 4, 1, 2, 3).contiguous())
        if "logits" in cfg.sg_cuts:
            logits = logits.detach()
        attn_weight = torch.softmax(logits, dim=1)  # (B, D, H, W)

        # winner-take-all depth; torch.argmax returns the first maximum
        idx = torch.argmax(attn_weight, dim=1, keepdim=True)
        depth = torch.gather(depth_hypo, 1, idx)[:, 0]  # (B, H, W)

        conf = torch.max(attn_weight, dim=1).values
        up = 2 ** (3 - stage_idx)
        if up > 1 and resize is None:
            conf = resize_bilinear_align_corners(
                conf[..., None], conf.shape[1] * up, conf.shape[2] * up
            )[..., 0]
        elif up > 1:
            conf = resize(conf, conf.shape[1] * up, conf.shape[2] * up)

        ret = {
            "depth": depth,
            "photometric_confidence": conf,
            "hypo_depth": depth_hypo,
            "attn_weight": attn_weight,
        }
        if cfg.inverse_depth:
            itv = 1.0 / depth_hypo[:, 2] - 1.0 / depth_hypo[:, 1]
            split = cfg.depth_interals_ratio[stage_idx]
            ret["inverse_min_depth"] = 1.0 / depth + split * itv
            ret["inverse_max_depth"] = 1.0 / depth - split * itv
        if cfg.mono:
            ret["mono_feat"] = ref_feat
        return ret
