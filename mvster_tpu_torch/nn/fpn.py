"""Feature pyramids and their fusion (counterpart of mvster_tpu.nn.fpn, standard branches).

FPN4: a strided conv encoder, lateral 1x1 convs and an align-corners
bilinear top-down path.  FPN4ConvNeXt / FPN4ConvNeXt4: the same top-down
path over two conv stems (`conv0_0`, `conv0_1`) and three ConvNeXt
downsampling blocks.  All output channels [8b, 4b, 2b, b] at strides
[8, 4, 2, 1], keyed stage1..stage4; with `dcn`, a DeformConvBlock
(`dcn1..dcn4`) follows each output head, each call inside a `mvs.dcn`
span (utils/profiling; four a forward, inside the model's `mvs.fpn`).
The JAX package's eval-only composed tail (compose_tail) is an algebraic
rewrite of the same function; the port runs the standard formulation
that the reference checkpoint defines.

Compute dtype: FPN4 casts its input to `dtype` and runs every conv in it
(norms in float32), so its heads emit `dtype`; the ConvNeXt pyramids,
DCN and ASFF get none and run in float32, as in the JAX package.

ASFF (adaptive spatial feature fusion) takes one view's four levels,
channels-last, and returns the fused level `level`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvster_tpu_torch.core.sampling import max_pool2d, upsample_nearest
from mvster_tpu_torch.nn.blocks import Conv2d, ConvBlock2d
from mvster_tpu_torch.nn.dcn import DeformConvBlock
from mvster_tpu_torch.utils.profiling import span


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class _TopDown(nn.Module):
    """The lateral convs, output heads and top-down path shared by the
    pyramids, and the optional DCN blocks after the heads."""

    def _init_top_down(self, b: int, dcn: bool, dtype: torch.dtype | None = None):
        self.out_channels = [8 * b, 4 * b, 2 * b, b]
        final = 8 * b
        conv = lambda cin, cout, k, bias: Conv2d(  # noqa: E731
            cin, cout, k, padding=k // 2, bias=bias, dtype=dtype)
        self.out1 = conv(final, 8 * b, 1, False)
        self.inner1 = conv(4 * b, final, 1, True)
        self.inner2 = conv(2 * b, final, 1, True)
        self.inner3 = conv(b, final, 1, True)
        self.out2 = conv(final, 4 * b, 3, False)
        self.out3 = conv(final, 2 * b, 3, False)
        self.out4 = conv(final, b, 3, False)
        self.dcn = dcn
        if dcn:
            for i, c in enumerate(self.out_channels, 1):
                setattr(self, f"dcn{i}", DeformConvBlock(c))

    def _top_down(self, conv0, conv1, conv2, conv3, resize=None) -> dict[str, torch.Tensor]:
        """`resize(x, out_h, out_w)`: an align-corners bilinear resize for
        the 2x upsampling in place of F.interpolate's (dist/spatial.py gives
        one for a band of image rows)."""
        up2 = _up2 if resize is None else lambda x: resize(x, 2 * x.shape[-2], 2 * x.shape[-1])
        intra = conv3
        outs = [self.out1(intra)]
        for lateral, inner, out in ((conv2, self.inner1, self.out2),
                                    (conv1, self.inner2, self.out3),
                                    (conv0, self.inner3, self.out4)):
            intra = up2(intra) + inner(lateral)
            outs.append(out(intra))
        if self.dcn:
            for i, o in enumerate(outs):
                with span("mvs.dcn"):
                    outs[i] = getattr(self, f"dcn{i + 1}")(o)
        return {f"stage{i}": o for i, o in enumerate(outs, 1)}


class FPN4(_TopDown):
    """(N, 3, H, W) images -> {"stage1".."stage4": (N, C_s, H/2^(4-s), W/2^(4-s))}."""

    def __init__(self, base_channels: int = 8, dcn: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        b = base_channels
        self.dtype = dtype

        def encoder(cin, cout, first):
            k, s, p = first
            return nn.Sequential(
                ConvBlock2d(cin, cout, k, s, p, dtype=dtype),
                *[ConvBlock2d(cout, cout, 3, 1, 1, dtype=dtype)
                  for _ in range(1 if s == 1 else 2)],
            )

        self.conv0 = encoder(3, b, (3, 1, 1))
        self.conv1 = encoder(b, 2 * b, (5, 2, 2))
        self.conv2 = encoder(2 * b, 4 * b, (5, 2, 2))
        self.conv3 = encoder(4 * b, 8 * b, (5, 2, 2))
        self._init_top_down(b, dcn, dtype)

    def forward(self, x: torch.Tensor, resize=None) -> dict[str, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        conv3 = self.conv3(conv2)
        return self._top_down(conv0, conv1, conv2, conv3, resize)


class _ConvNeXtLayers(nn.Module):
    """The layers after a ConvNeXt block's depthwise conv: a channels-last
    LayerNorm (eps 1e-6), `pwconv1` (2 dim -> 4 dim) and `pwconv2` as
    Linear layers around an exact GELU, and the layer scale `gamma`."""

    def __init__(self, dim: int, layer_scale_init: float):
        super().__init__()
        out = 2 * dim
        self.norm = nn.LayerNorm(out, eps=1e-6)
        self.pwconv1 = nn.Linear(out, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, out)
        self.gamma = nn.Parameter(torch.full((out,), layer_scale_init))

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(x.permute(0, 2, 3, 1))
        x = self.pwconv2(F.gelu(self.pwconv1(x)))
        return (self.gamma * x).permute(0, 3, 1, 2)


class ConvNeXtBlock(_ConvNeXtLayers):
    """Downsampling ConvNeXt block (the reference's convnext_block), no
    residual: a depthwise 7x7 conv with stride 2 and groups=dim emitting
    2 dim channels, then the layers above."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__(dim, layer_scale_init)
        self.dwconv = nn.Conv2d(dim, 2 * dim, 7, stride=2, padding=3, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._mlp(self.dwconv(x))


class ConvNeXt4Block(_ConvNeXtLayers):
    """Patchify ConvNeXt block (the reference's convnext4_block): a 2x2
    `sconv` with stride 2 to 2 dim channels, then a residual depthwise 7x7
    conv (groups=dim) and the layers above."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__(dim, layer_scale_init)
        self.sconv = nn.Conv2d(dim, 2 * dim, 2, stride=2)
        self.dwconv = nn.Conv2d(2 * dim, 2 * dim, 7, padding=3, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = self.sconv(x)
        return inp + self._mlp(self.dwconv(inp))


class FPN4ConvNeXt(_TopDown):
    """FPN4's interface over two conv stems and three ConvNeXt blocks;
    float32 whatever the model's compute dtype."""

    block = ConvNeXtBlock

    def __init__(self, base_channels: int = 8, dcn: bool = False):
        super().__init__()
        b = base_channels
        self.conv0_0 = ConvBlock2d(3, b, 3, 1, 1)
        self.conv0_1 = ConvBlock2d(b, b, 3, 1, 1)
        self.conv1 = self.block(b)
        self.conv2 = self.block(2 * b)
        self.conv3 = self.block(4 * b)
        self._init_top_down(b, dcn)

    def forward(self, x: torch.Tensor, resize=None) -> dict[str, torch.Tensor]:
        conv0 = self.conv0_1(self.conv0_0(x))
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        conv3 = self.conv3(conv2)
        return self._top_down(conv0, conv1, conv2, conv3, resize)


class FPN4ConvNeXt4(FPN4ConvNeXt):
    block = ConvNeXt4Block


def _nchw(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW block to a channels-last (B, H, W, C) tensor."""
    return block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ASFF(nn.Module):
    """Adaptive spatial feature fusion of the four levels at level `level`
    (0 = stage1, the coarsest): the others resampled to it (stride-2 conv
    blocks, after a max pool for two or three levels down; a 1x1 conv block
    and nearest upsampling up), blended by softmax weights per pixel, then
    a 3x3 conv block.  dims are the levels' channels (64, 32, 16, 8), as
    in the JAX package; float32."""

    def __init__(self, level: int, dims: tuple[int, ...] = (64, 32, 16, 8)):
        super().__init__()
        self.level = level
        inter = dims[level]
        for i, c in enumerate(dims):
            if i < level:
                setattr(self, f"compress_level_{i}", ConvBlock2d(c, inter, 1, 1, 0))
            elif i > level:
                setattr(self, f"stride_level_{i}", ConvBlock2d(c, inter, 3, 2, 1))
        for i in range(4):
            setattr(self, f"weight_level_{i}", ConvBlock2d(inter, 8, 1, 1, 0))
        self.weight_levels = nn.Conv2d(4 * 8, 4, 1)
        self.expand = ConvBlock2d(inter, inter, 3, 1, 1)

    def forward(self, x0, x1, x2, x3) -> torch.Tensor:
        """x0..x3: one view's levels (B, H_i, W_i, C_i) -> (B, H_l, W_l, dims[l])."""
        lvl = self.level
        resized = []
        for i, x in enumerate((x0, x1, x2, x3)):
            x = x.to(self.weight_levels.weight.dtype)
            if i < lvl:
                x = upsample_nearest(_nchw(getattr(self, f"compress_level_{i}"), x),
                                     2 ** (lvl - i))
            elif i > lvl:
                if i - lvl > 1:
                    pool = 2 ** (i - lvl - 1)
                    x = max_pool2d(x, pool, pool)
                x = _nchw(getattr(self, f"stride_level_{i}"), x)
            resized.append(x)
        weights = torch.cat([_nchw(getattr(self, f"weight_level_{i}"), r)
                             for i, r in enumerate(resized)], dim=-1)
        w = torch.softmax(_nchw(self.weight_levels, weights), dim=-1)
        fused = sum(r * w[..., i:i + 1] for i, r in enumerate(resized))
        return _nchw(self.expand, fused)
