"""The plain reference of MVSTER's dtu_default cascade, in plain PyTorch.

A frozen, functional copy of the published model (JeffWang987/MVSTER
models/MVS4Net.py, models/mvs4net_utils.py) as the flags
`--group_cor --inverse_depth --mono --attn_temp 2` configure it: FPN4 with
base 8, per stage D inverse-depth hypotheses, the plane-sweep warp with
zero padding, group correlation weighted by a per-view softmax over depth
(attention temperature 2, scaled 1/sqrt(C)), Reg2d, a softmax over depth,
the winner-take-all depth, the max-probability confidence upsampled to
full resolution, and in training the monocular decoder.

Weights are a state dict in the reference checkpoint's key grammar
(`feature.*`, `reg.{s}.*`, `mono_depth_decoder.*`).  Layouts: images
(B, V, H, W, 3), projections {stage: (B, V, 2, 4, 4)}, depth_values (B, K).
The geometry (projections, plane-sweep coordinates) follows the arithmetic
that the system's geometry specifies (FMA chains in float32), so reference
and system sample the source maps at the same coordinates: at 1152 pixels
a float32 coordinate is good to ~1e-4 pixel, and on random images that
alone moves the sharp stage-4 softmax by far more than the rest of float32
arithmetic does.  The rest runs in float32.  No
kernel, cache or batching of the system under test is used here: this file
imports torch alone.

`Config.lower = "tf32"` computes every convolution from operands rounded to
TF32 (10 mantissa bits, to nearest), as a card's TF32 tensor cores take
them, with float32 sums: the nearest precision below the configuration's
float32, for the control of the correctness check.

`stage_depths` replays a served cascade: stage s > 1 takes its hypotheses
from the given stage s - 1 depth instead of its own, so each stage of a
served answer is judged on the window that the answer itself chose.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
MONO_OUT = (32, 16, 8)

# the configuration's model keys this reference reads (None) or computes at
# one value only
MODEL_KEYS = {"ndepths": None, "depth_inter_r": None, "group_cor_dim": None,
              "fpn_base_channel": None, "reg_channel": None, "attn_temp": None, "mono": None,
              "group_cor": True, "inverse_depth": True, "compute_dtype": "float32"}


class Config:
    """The settings of the cascade that the reference reads."""

    def __init__(self, ndepths=(8, 8, 4, 4), depth_inter_r=(0.5, 0.5, 0.5, 1.0),
                 group_cor_dim=(8, 8, 4, 4), fpn_base=8, reg_base=8,
                 attn_temp=2.0, mono=True, lower=None):
        self.ndepths = tuple(ndepths)
        self.depth_inter_r = tuple(depth_inter_r)
        self.group_cor_dim = tuple(group_cor_dim)
        self.fpn_base = fpn_base
        self.reg_base = reg_base
        self.attn_temp = attn_temp
        self.mono = mono
        self.lower = lower


def config(model: dict) -> Config:
    """The Config of a configuration's `model` (the port's CLI flag names)."""
    ints = lambda s: tuple(int(x) for x in str(s).split(","))  # noqa: E731
    return Config(ndepths=ints(model["ndepths"]),
                  depth_inter_r=tuple(float(x) for x in str(model["depth_inter_r"]).split(",")),
                  group_cor_dim=ints(model["group_cor_dim"]),
                  fpn_base=int(model["fpn_base_channel"]), reg_base=int(model["reg_channel"]),
                  attn_temp=float(model["attn_temp"]), mono=bool(model.get("mono")))


def tf32(x):
    """x rounded to TF32's 10 mantissa bits, to nearest (ties away); the
    gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach())


def conv(cfg, fn, x, w, b=None, *args):
    """fn(x, w, b, *args), the operands rounded first under cfg.lower."""
    if cfg.lower == "tf32":
        x, w = tf32(x), tf32(w)
        b = None if b is None else tf32(b)
    return fn(x, w, b, *args)


def state_shapes(cfg):
    """{key: shape} of every weight and buffer, in the checkpoint's grammar
    (BatchNorm: weight, bias, running_mean, running_var, num_batches_tracked;
    transposed convolutions (in, out, *k))."""
    shapes = {}

    def conv_bn(key, cout, cin, *k):
        shapes[key + ".conv.weight"] = (cout, cin, *k)
        norm(key + ".bn", cout)

    def norm(key, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{leaf}"] = (c,)
        shapes[key + ".num_batches_tracked"] = ()

    b, p = cfg.fpn_base, "feature."
    conv_bn(p + "conv0.0", b, 3, 3, 3)
    conv_bn(p + "conv0.1", b, b, 3, 3)
    for i, (cin, cout) in enumerate(((b, 2 * b), (2 * b, 4 * b), (4 * b, 8 * b)), 1):
        conv_bn(f"{p}conv{i}.0", cout, cin, 5, 5)
        conv_bn(f"{p}conv{i}.1", cout, cout, 3, 3)
        conv_bn(f"{p}conv{i}.2", cout, cout, 3, 3)
    shapes[p + "out1.weight"] = (8 * b, 8 * b, 1, 1)
    for i, c in enumerate((4 * b, 2 * b, b), 1):
        shapes[f"{p}inner{i}.weight"] = (8 * b, c, 1, 1)
        shapes[f"{p}inner{i}.bias"] = (8 * b,)
        shapes[f"{p}out{i + 1}.weight"] = (c, 8 * b, 3, 3)
    r = cfg.reg_base
    for s, g in enumerate(cfg.group_cor_dim):
        p = f"reg.{s}."
        conv_bn(p + "conv0", r, g, 1, 3, 3)
        for i, (cin, cout) in ((1, (r, 2 * r)), (3, (2 * r, 4 * r)), (5, (4 * r, 8 * r))):
            conv_bn(f"{p}conv{i}", cout, cin, 1, 3, 3)
            conv_bn(f"{p}conv{i + 1}", cout, cout, 3, 3, 3)
        for i, (cin, cout) in ((7, (8 * r, 4 * r)), (9, (4 * r, 2 * r)), (11, (2 * r, r))):
            shapes[f"{p}conv{i}.0.weight"] = (cin, cout, 1, 3, 3)
            norm(f"{p}conv{i}.1", cout)
        shapes[p + "prob.weight"] = (1, r, 1, 1, 1)
        shapes[p + "prob.bias"] = (1,)
    if cfg.mono:
        feat = (8 * b, 4 * b, 2 * b, b)
        for i, c in enumerate(MONO_OUT):
            conv_bn(f"mono_depth_decoder.convblocks.{i}", c, feat[i], 3, 3)
            shapes[f"mono_depth_decoder.conv3x3.{i}.weight"] = (1, c + feat[i + 1], 3, 3)
            shapes[f"mono_depth_decoder.conv3x3.{i}.bias"] = (1,)
    return shapes


def batch_norm(x, sd, key, train):
    """BatchNorm over every axis but the channels: the batch's mean and
    biased variance in training, the running statistics in eval."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        dims = [0, *range(2, x.dim())]
        var, mean = torch.var_mean(x, dim=dims, unbiased=False)
    else:
        mean, var = sd[key + ".running_mean"], sd[key + ".running_var"]
    y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + BN_EPS)
    return y * sd[key + ".weight"].reshape(shape) + sd[key + ".bias"].reshape(shape)


def conv_bn_relu(cfg, x, sd, key, stride=1, padding=1, train=False, relu=True):
    """conv (no bias) -> BatchNorm -> ReLU, 2D or 3D by the weight's rank."""
    w = sd[key + ".conv.weight"]
    fn = F.conv2d if w.dim() == 4 else F.conv3d
    y = batch_norm(conv(cfg, fn, x, w, None, stride, padding), sd, key + ".bn", train)
    return torch.relu(y) if relu else y


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def fpn4(cfg, sd, x, train):
    """(N, 3, H, W) -> [stage1 .. stage4] features, strides 8, 4, 2, 1."""
    p = "feature."
    c0 = conv_bn_relu(cfg, x, sd, p + "conv0.0", 1, 1, train)
    c0 = conv_bn_relu(cfg, c0, sd, p + "conv0.1", 1, 1, train)
    convs = [c0]
    for i in (1, 2, 3):
        y = conv_bn_relu(cfg, convs[-1], sd, f"{p}conv{i}.0", 2, 2, train)
        y = conv_bn_relu(cfg, y, sd, f"{p}conv{i}.1", 1, 1, train)
        y = conv_bn_relu(cfg, y, sd, f"{p}conv{i}.2", 1, 1, train)
        convs.append(y)
    intra = convs[3]
    outs = [conv(cfg, F.conv2d, intra, sd[p + "out1.weight"])]
    for lateral, i in ((convs[2], 1), (convs[1], 2), (convs[0], 3)):
        inner = conv(cfg, F.conv2d, lateral, sd[f"{p}inner{i}.weight"], sd[f"{p}inner{i}.bias"])
        intra = up2(intra) + inner
        outs.append(conv(cfg, F.conv2d, intra, sd[f"{p}out{i + 1}.weight"], None, 1, 1))
    return outs


def reg2d(cfg, sd, s, x, train):
    """Stage s's U-Net: (B, G, D, H, W) -> (B, D, H, W) logits."""
    p = f"reg.{s}."
    k133 = dict(stride=1, padding=(0, 1, 1), train=train)
    down = dict(stride=(1, 2, 2), padding=(0, 1, 1), train=train)
    c0 = conv_bn_relu(cfg, x, sd, p + "conv0", **k133)
    c2 = conv_bn_relu(cfg, conv_bn_relu(cfg, c0, sd, p + "conv1", **down), sd, p + "conv2",
                      1, 1, train)
    c4 = conv_bn_relu(cfg, conv_bn_relu(cfg, c2, sd, p + "conv3", **down), sd, p + "conv4",
                      1, 1, train)
    y = conv_bn_relu(cfg, conv_bn_relu(cfg, c4, sd, p + "conv5", **down), sd, p + "conv6",
                     1, 1, train)
    for skip, i in ((c4, 7), (c2, 9), (c0, 11)):
        t = conv(cfg, F.conv_transpose3d, y, sd[f"{p}conv{i}.0.weight"], None, (1, 2, 2),
                 (0, 1, 1), (0, 1, 1))
        y = skip + torch.relu(batch_norm(t, sd, f"{p}conv{i}.1", train))
    return conv(cfg, F.conv3d, y, sd[p + "prob.weight"], sd[p + "prob.bias"])[:, 0]


def mono_decoder(cfg, sd, feats, d_min, d_max, train):
    """Stage 1-4 reference features (B, C, h, w) -> {stage: (B, h, w) depth}
    for stages 2-4."""
    p = "mono_depth_decoder."
    min_disp = (1.0 / d_max)[:, None, None]
    max_disp = (1.0 / d_min)[:, None, None]
    out = {}
    for i in range(3):
        small = conv_bn_relu(cfg, feats[i], sd, f"{p}convblocks.{i}", 1, 1, train)
        small = F.interpolate(small, scale_factor=2, mode="nearest")
        x = torch.cat([small, feats[i + 1]], dim=1)
        disp = torch.sigmoid(conv(cfg, F.conv2d, x, sd[f"{p}conv3x3.{i}.weight"],
                                  sd[f"{p}conv3x3.{i}.bias"], 1, 1))[:, 0]
        out[f"stage{i + 2}"] = 1.0 / (min_disp + (max_disp - min_disp) * disp)
    return out


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _matmul(a, b):
    """a @ b of small (..., M, K) @ (..., K, N) float32 matrices as a chain
    of fused multiply-adds over k = 0, 1, ..."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = _fma(a[..., :, k:k + 1], b[..., k:k + 1, :], acc)
    return acc


def _inverse_affine(m):
    """Inverse of affine (..., 4, 4) float32 matrices by the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = (e * i - f * h, f * g - d * i, d * h - e * g)
    det = a * co[0] + b * co[1] + c * co[2]
    adj = torch.stack([torch.stack([co[0], c * h - b * i, b * f - c * e], -1),
                       torch.stack([co[1], a * i - c * g, c * d - a * f], -1),
                       torch.stack([co[2], b * g - a * h, a * e - b * d], -1)], -2)
    inv = adj / det[..., None, None]
    top = torch.cat([inv, -_matmul(inv, m[..., :3, 3:4])], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def composed(proj):
    """(..., 2, 4, 4) (extrinsic, intrinsic) -> (..., 4, 4), the top three
    rows K @ E[:3]."""
    extr = proj[..., 0, :, :]
    top = _matmul(proj[..., 1, :3, :3], extr[..., :3, :4])
    return torch.cat([top, extr[..., 3:4, :]], dim=-2)


def sweep_coords(src_proj, ref_proj, hypo):
    """Source pixel coordinates (x, y), each (B, D, H, W), of every reference
    pixel at every hypothesis.  The arithmetic is the one the system's
    geometry specifies, so both sample at the same float32 coordinates:
    rel = src @ ref^-1 by FMA chains; ray_i = fma(rel[i, 1], y,
    rel[i, 0] * x) + rel[i, 2]; p_i = ray_i * d + rel[i, 3]; x, y = p_0 / z,
    p_1 / z with z == 0 taken as 1e-9."""
    _, _, h, w = hypo.shape
    rel = _matmul(src_proj, _inverse_affine(ref_proj))
    xs = torch.arange(w, dtype=hypo.dtype, device=hypo.device).view(1, 1, w)
    ys = torch.arange(h, dtype=hypo.dtype, device=hypo.device).view(1, h, 1)

    def coord(i):
        r0, r1, r2, t = (rel[:, i, j].view(-1, 1, 1) for j in range(4))
        ray = (_fma(r1, ys, r0 * xs) + r2)[:, None]
        return ray * hypo + t[..., None]

    px, py, pz = coord(0), coord(1), coord(2)
    pz = torch.where(pz == 0.0, torch.full_like(pz, 1e-9), pz)
    return px / pz, py / pz


def bilinear_zeros(img, x, y):
    """Sample img (B, Hs, Ws, C) at pixel coordinates x, y (B, ...), each
    of the four taps zero outside the image -> (B, ..., C)."""
    b, hs, ws, c = img.shape
    flat = img.reshape(b, hs * ws, c)
    xf, yf = x.reshape(b, -1), y.reshape(b, -1)
    x0, y0 = torch.floor(xf), torch.floor(yf)
    fx, fy = xf - x0, yf - y0
    x0 = x0.clamp(-2, ws + 1).long()
    y0 = y0.clamp(-2, hs + 1).long()
    bidx = torch.arange(b, device=img.device)[:, None]
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < ws) & (yi >= 0) & (yi < hs)
        idx = yi.clamp(0, hs - 1) * ws + xi.clamp(0, ws - 1)
        out = out + flat[bidx, idx] * (wgt * inside)[..., None]
    return out.reshape(*x.shape, c)


def cost_volume(ref, srcs, ref_proj, src_projs, hypo, groups, attn_temp):
    """Group-correlation volume (B, G, D, H, W): each source view's
    correlation with the reference, weighted by its softmax over depth of
    the summed correlation / attn_temp, scaled 1/sqrt(C), and normalised
    by the weights' sum (which starts at 1e-8).  ref (B, H, W, C), srcs
    V - 1 maps (B, H, W, C)."""
    b, h, w, c = ref.shape
    d = hypo.shape[1]
    ref_g = ref.reshape(b, 1, h, w, groups, c // groups)
    weight_sum, volume = 1e-8, 0.0
    for src, src_proj in zip(srcs, src_projs):
        x, y = sweep_coords(src_proj, ref_proj, hypo)
        warped = bilinear_zeros(src, x.detach(), y.detach())  # (B, D, H, W, C)
        cor = (warped.reshape(b, d, h, w, groups, c // groups) * ref_g).mean(-1)
        weight = torch.softmax(cor.sum(-1) / attn_temp, dim=1) / math.sqrt(c)
        weight_sum = weight_sum + weight
        volume = volume + weight[..., None] * cor
    volume = volume / weight_sum[..., None]
    return volume.permute(0, 4, 1, 2, 3)


def inverse_hypotheses(depth_values, d, h, w):
    """Stage 1: D depths uniform in inverse depth, index 0 the far plane."""
    inv_min = 1.0 / depth_values[:, 0]
    inv_max = 1.0 / depth_values[:, -1]
    t = torch.arange(d, dtype=depth_values.dtype, device=depth_values.device) / (d - 1)
    hypo = 1.0 / (inv_max[:, None] + (inv_min - inv_max)[:, None] * t)
    return hypo[:, :, None, None].expand(-1, -1, h, w).contiguous()


def next_hypotheses(depth, prev_hypo, ratio, d, h, w):
    """Stage s > 1: D inverse depths between the bounds around the previous
    stage's depth (B, h/2, w/2), `ratio` (the previous stage's) times its
    inverse-depth interval either side, upsampled to (D, h, w) trilinearly."""
    itv = 1.0 / prev_hypo[:, 2] - 1.0 / prev_hypo[:, 1]
    inv_min = 1.0 / depth + ratio * itv
    inv_max = 1.0 / depth - ratio * itv
    t = torch.arange(d, dtype=depth.dtype, device=depth.device) / (d - 1)
    inv = inv_max[:, None] + (inv_min - inv_max)[:, None] * t[None, :, None, None]
    inv = F.interpolate(inv[:, None], size=(d, h, w), mode="trilinear",
                        align_corners=True)[:, 0]
    return 1.0 / inv


def forward(sd, cfg, imgs, projs, depth_values, train=False, stage_depths=None):
    """The cascade.  Returns {stage: {depth, confidence, hypo, attn}} (the
    confidence at full resolution) and, in training with cfg.mono,
    {stage: mono_depth} for stages 2-4."""
    b, v, h, w, _ = imgs.shape
    flat = imgs.reshape(b * v, h, w, 3).permute(0, 3, 1, 2)
    feats = [f.permute(0, 2, 3, 1).reshape(b, v, *f.shape[2:], f.shape[1])
             for f in fpn4(cfg, sd, flat, train)]
    outs, hypo, depth = {}, None, None
    for s in range(4):
        key = f"stage{s + 1}"
        feat = feats[s]
        hs, ws = feat.shape[2], feat.shape[3]
        d = cfg.ndepths[s]
        if s == 0:
            hypo = inverse_hypotheses(depth_values, d, hs, ws)
        else:
            prev = depth if stage_depths is None else stage_depths[f"stage{s}"]
            hypo = next_hypotheses(prev.detach(), hypo.detach(),
                                   cfg.depth_inter_r[s - 1], d, hs, ws)
        comp = composed(projs[key])
        volume = cost_volume(feat[:, 0], feat[:, 1:].unbind(1), comp[:, 0],
                             comp[:, 1:].unbind(1), hypo, cfg.group_cor_dim[s],
                             cfg.attn_temp)
        attn = torch.softmax(reg2d(cfg, sd, s, volume, train), dim=1)
        depth = torch.gather(hypo, 1, attn.argmax(1, keepdim=True))[:, 0]
        conf = attn.max(1).values
        if s < 3:
            conf = F.interpolate(conf[:, None], size=(h, w), mode="bilinear",
                                 align_corners=True)[:, 0]
        outs[key] = {"depth": depth, "confidence": conf, "hypo": hypo, "attn": attn}
    mono = {}
    if train and cfg.mono:
        ref_feats = [f[:, 0].permute(0, 3, 1, 2) for f in feats]
        mono = mono_decoder(cfg, sd, ref_feats, depth_values[:, 0], depth_values[:, 1], train)
    return outs, mono
