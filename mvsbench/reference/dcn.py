"""The plain reference of MVSTER with deformable-conv heads (`--dcn`), in
plain PyTorch.

The cascade of `model` with a modulated deformable 3x3 convolution
(DCNv2: Zhu et al., "Deformable ConvNets v2", CVPR 2019) after each of
FPN4's four outputs, as the published model's `NA_DCN` places it
(JeffWang987/MVSTER models/mvs4net_utils.py: BatchNorm, ReLU, then
`DeformConvPack`; flag `--dcn` of train_mvs4.py and test_mvs4.py).  Each
head of C channels at h x w, with n = 9 taps t = ki * 3 + kj:

  offsets  a 3x3 conv with bias to 2n channels, laid out [dy x n | dx x n];
  mask     the sigmoid of a 3x3 conv with bias to n channels;
  taps     at pixel (i, j) and tap t, the point (i + 1 + ki - 1 + dy,
           j + 1 + kj - 1 + dx) of the input zero-padded by one pixel,
           clamped to the padded map's border and sampled bilinearly from
           its four corners (each corner clamped to the map), times the mask;
  output   sum over t and c of weight[o, c, ki, kj] x tap[t, c]: the dense
           (9C -> C) contraction, no bias.

Departures from the published NA_DCN, each that of the published
repository's own pure-PyTorch fallback (`DeformConv2d`,
models/mvs4net_utils.py): the offset and mask convs are two convs,
`p_conv` (2n) and `m_conv` (n), where the external `DeformConvPack` has
one `conv_offset` of 3n; a tap outside the padded map is clamped to its
border where the external op reads zero there.

The state dict adds to `model`'s, per head s = 1..4, `feature.dcn{s}.0.*`
(the BatchNorm), `feature.dcn{s}.2.weight` (C, C, 3, 3),
`feature.dcn{s}.2.p_conv.{weight,bias}` and `feature.dcn{s}.2.m_conv.*`.
A tap's coordinate is an integer plus the offset, rounded once in
float32, as the system under test forms it.  Under `Config.lower = "tf32"`
the offset and mask convs and the contraction take TF32 operands, with
float32 sums.  This file imports torch and `model` alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvsbench.reference import model as base

MODEL_KEYS = {**base.MODEL_KEYS, "dcn": True}
TAPS = 9
config = base.config


def state_shapes(cfg):
    shapes = base.state_shapes(cfg)
    b = cfg.fpn_base
    for s, c in enumerate((8 * b, 4 * b, 2 * b, b), 1):
        p = f"feature.dcn{s}."
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{p}0.{leaf}"] = (c,)
        shapes[p + "0.num_batches_tracked"] = ()
        shapes[p + "2.weight"] = (c, c, 3, 3)
        shapes[p + "2.p_conv.weight"] = (2 * TAPS, c, 3, 3)
        shapes[p + "2.p_conv.bias"] = (2 * TAPS,)
        shapes[p + "2.m_conv.weight"] = (TAPS, c, 3, 3)
        shapes[p + "2.m_conv.bias"] = (TAPS,)
    return shapes


def sample_clamped(padded, y, x):
    """padded (N, C, Hp, Wp) at float coordinates y, x (N, H, W), clamped to
    the map, bilinear from the four corners, each corner clamped to the map
    -> (N, C, H, W)."""
    n, c, hp, wp = padded.shape
    y = y.clamp(0.0, hp - 1.0)
    x = x.clamp(0.0, wp - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0i, x0i = y0.long().clamp(0, hp - 1), x0.long().clamp(0, wp - 1)
    y1i, x1i = (y0i + 1).clamp(max=hp - 1), (x0i + 1).clamp(max=wp - 1)
    flat = padded.reshape(n, c, hp * wp)

    def corner(yi, xi):
        idx = (yi * wp + xi).reshape(n, 1, -1).expand(n, c, -1)
        return flat.gather(2, idx).reshape(n, c, *y.shape[1:])

    w00, w01 = ((1 - fy) * (1 - fx))[:, None], ((1 - fy) * fx)[:, None]
    w10, w11 = (fy * (1 - fx))[:, None], (fy * fx)[:, None]
    return (corner(y0i, x0i) * w00 + corner(y0i, x1i) * w01
            + corner(y1i, x0i) * w10 + corner(y1i, x1i) * w11)


def deform_conv(cfg, sd, key, x):
    """The modulated deformable 3x3 conv `key` of x (N, C, H, W) -> (N, C, H, W)."""
    n, c, h, w = x.shape
    offsets = base.conv(cfg, F.conv2d, x, sd[key + ".p_conv.weight"],
                        sd[key + ".p_conv.bias"], 1, 1)
    mask = torch.sigmoid(base.conv(cfg, F.conv2d, x, sd[key + ".m_conv.weight"],
                                   sd[key + ".m_conv.bias"], 1, 1))
    weight = sd[key + ".weight"]
    if cfg.lower == "tf32":
        weight = base.tf32(weight)
    padded = F.pad(x, (1, 1, 1, 1))
    rows = torch.arange(h, dtype=x.dtype, device=x.device).view(1, h, 1)
    cols = torch.arange(w, dtype=x.dtype, device=x.device).view(1, 1, w)
    out = 0.0
    for t in range(TAPS):
        ki, kj = divmod(t, 3)
        y = (rows + ki) + offsets[:, t]  # (i + 1) + (ki - 1): the padded map's row
        xx = (cols + kj) + offsets[:, TAPS + t]
        tap = sample_clamped(padded, y, xx) * mask[:, t:t + 1]
        if cfg.lower == "tf32":
            tap = base.tf32(tap)
        out = out + torch.einsum("nchw,oc->nohw", tap, weight[:, :, ki, kj])
    return out


def fpn4_dcn(cfg, sd, x, train):
    """FPN4's four outputs, each through BatchNorm, ReLU and its deformable conv."""
    outs = base.fpn4(cfg, sd, x, train)
    return [deform_conv(cfg, sd, f"feature.dcn{s}.2",
                        torch.relu(base.batch_norm(o, sd, f"feature.dcn{s}.0", train)))
            for s, o in enumerate(outs, 1)]


def forward(sd, cfg, imgs, projs, depth_values, train=False, stage_depths=None):
    """`model.forward` with the deformable heads on FPN4's outputs."""
    b, v, h, w, _ = imgs.shape
    flat = imgs.reshape(b * v, h, w, 3).permute(0, 3, 1, 2)
    feats = [f.permute(0, 2, 3, 1).reshape(b, v, *f.shape[2:], f.shape[1])
             for f in fpn4_dcn(cfg, sd, flat, train)]
    outs, hypo, depth = {}, None, None
    for s in range(4):
        key = f"stage{s + 1}"
        feat = feats[s]
        hs, ws = feat.shape[2], feat.shape[3]
        d = cfg.ndepths[s]
        if s == 0:
            hypo = base.inverse_hypotheses(depth_values, d, hs, ws)
        else:
            prev = depth if stage_depths is None else stage_depths[f"stage{s}"]
            hypo = base.next_hypotheses(prev.detach(), hypo.detach(),
                                        cfg.depth_inter_r[s - 1], d, hs, ws)
        comp = base.composed(projs[key])
        volume = base.cost_volume(feat[:, 0], feat[:, 1:].unbind(1), comp[:, 0],
                                  comp[:, 1:].unbind(1), hypo, cfg.group_cor_dim[s],
                                  cfg.attn_temp)
        attn = torch.softmax(base.reg2d(cfg, sd, s, volume, train), dim=1)
        depth = torch.gather(hypo, 1, attn.argmax(1, keepdim=True))[:, 0]
        conf = attn.max(1).values
        if s < 3:
            conf = F.interpolate(conf[:, None], size=(h, w), mode="bilinear",
                                 align_corners=True)[:, 0]
        outs[key] = {"depth": depth, "confidence": conf, "hypo": hypo, "attn": attn}
    mono = {}
    if train and cfg.mono:
        ref_feats = [f[:, 0].permute(0, 3, 1, 2) for f in feats]
        mono = base.mono_decoder(cfg, sd, ref_feats, depth_values[:, 0], depth_values[:, 1],
                                 train)
    return outs, mono
