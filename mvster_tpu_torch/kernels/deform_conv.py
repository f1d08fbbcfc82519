"""The DCN heads' deformable sampling and contraction: K7, a CUDA kernel.

`deform_conv(x, offsets, mask, weight, row0)` computes what
nn/dcn.DeformConv2d.forward defines after its offset and modulation convs:
a modulated deformable 3x3 conv, stride 1, padding 1, no bias, of the map
x (B, C, Hw, W) with `offsets` (B, 18, h, W), p_conv's raw output laid out
[dy x 9 | dx x 9], and `mask` (B, 9, h, W), m_conv's raw output before its
sigmoid: per output pixel and tap the border-clamped bilinear sample of
the zero-padded map at (row + row0 + ty + dy, col + tx + dx), times the
tap's sigmoid(mask), contracted with weight (O, C, 3, 3) -> (B, O, h, W).
On a band of image rows (dist/spatial.py) x is the whole map gathered
from the bands and row0 the band's first row; elsewhere Hw = h, row0 = 0.

K7 (csrc/deform_conv.cu mvster_deform_conv) replaces no TPU kernel: the
JAX package computes this with gathers and a dense contraction.  It was
added because the plain version runs ~74 launches a head and writes a
(B, h, W, 9, C) tap tensor through HBM, 56.7 of a served --dcn view's ~103
device ms.  Its bound (~0.53 ms over the four heads of a served view at
832x1152, 5 images) and its design (a thread a pixel, 36 corner reads of
the channels-last map as 16-byte loads whatever the offsets, the weight in
shared memory, sums in registers in a fixed order) are in the source's
note.  K7 has no backward kernel: under autograd the call's backward
recomputes the plain version from the saved inputs and returns its
gradients (`_K7`; no benchmark cell trains --dcn, and the JAX package has
no kernel to port for it).

Dispatch, by the device alone: a CPU tensor takes the plain version,
`deform_conv_plain`; any other call launches K7, with autograd on or
off, or raises ValueError (no fallback).  K7 has instances
for float32 and O = C in 8, 16, 32, 64 (FPN4's heads at base 8: `CHANNELS`).
Under --compute_dtype bfloat16 the heads still see float32: their
BatchNorm casts its input to its float32 parameters.  The map is handed
to K7 channels last (one copy, `x.permute(0, 2, 3, 1).contiguous()`); the
output is (B, O, h, W), contiguous.  `deform_conv.launches` counts K7's
launches.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mvster_tpu_torch.kernels._build import check_tensor, load_library, raise_on_error

CHANNELS = (8, 16, 32, 64)  # K7's instances: O = C
TAPS = 9


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


def deform_conv_plain(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                      weight: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """The plain version (module docstring): border-clamped bilinear taps
    of the zero-padded map, the (B, h, W, n, C) tap tensor, one matmul."""
    k = weight.shape[-1]
    n, pad = k * k, (k - 1) // 2
    b, c, _, w = x.shape
    h = offsets.shape[2]
    offsets = offsets.permute(0, 2, 3, 1)  # (B, h, W, 2n)
    mod = torch.sigmoid(mask).permute(0, 2, 3, 1)  # (B, h, W, n)
    x_pad = F.pad(x, (pad, pad, pad, pad)).permute(0, 2, 3, 1)
    ar = lambda m: torch.arange(m, dtype=x.dtype, device=x.device)  # noqa: E731
    taps = ar(k) - pad
    ty, tx = taps.repeat_interleave(k), taps.repeat(k)  # (n,) as n = ki * k + kj
    py = (ar(h) + row0 + pad)[:, None, None] + ty + offsets[..., :n]  # (B, h, W, n)
    px = (ar(w) + pad)[None, :, None] + tx + offsets[..., n:]
    samples = _clamped_bilinear(x_pad, px, py) * mod[..., None]  # (B, h, W, n, C)
    kernel = weight.reshape(-1, c, n).permute(2, 1, 0)  # (n, C, O)
    out = samples.reshape(b * h * w, n * c) @ kernel.reshape(n * c, -1)
    return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def _check_instance(x, offsets, mask, weight, row0):
    """Raise ValueError, naming the reason, unless K7 has an instance for
    these tensors' dtypes and shapes."""
    for name, t in (("x", x), ("offsets", offsets), ("mask", mask), ("weight", weight)):
        if t.dtype != torch.float32:
            raise ValueError(f"K7 has float32 instances only: {name} is {t.dtype}")
    if x.dim() != 4 or offsets.dim() != 4 or mask.dim() != 4:
        raise ValueError(f"x, offsets and mask must be 4-d, got {tuple(x.shape)}, "
                         f"{tuple(offsets.shape)}, {tuple(mask.shape)}")
    o, c, kh, kw = weight.shape
    b, cx, hw_rows, w = x.shape
    if (kh, kw) != (3, 3) or o != c or c not in CHANNELS or cx != c:
        raise ValueError(f"K7 has instances for a 3x3 kernel with O = C in {CHANNELS}: "
                         f"weight {tuple(weight.shape)}, x {tuple(x.shape)}")
    h = offsets.shape[2]
    if offsets.shape != (b, 2 * TAPS, h, w) or mask.shape != (b, TAPS, h, w):
        raise ValueError(f"offsets {tuple(offsets.shape)} and mask {tuple(mask.shape)} must be "
                         f"({b}, {2 * TAPS}, h, {w}) and ({b}, {TAPS}, h, {w})")
    if not 0 <= row0 <= hw_rows - h or h < 1:
        raise ValueError(f"a band of {h} rows at row {row0} does not lie in a map of "
                         f"{hw_rows} rows")
    if max(x.numel(), offsets.numel(), b * c * h * w) >= 2**31:
        raise ValueError("K7 indexes with 32-bit integers: a tensor has 2**31 elements or more")


@functools.lru_cache(maxsize=None)
def _prepare(index: int) -> None:
    """Set K7's shared-memory attribute on device `index`, once."""
    lib = load_library()
    with torch.cuda.device(index):
        raise_on_error(lib, lib.mvster_deform_conv_prepare(), "mvster_deform_conv_prepare")


def _launch(x, offsets, mask, weight, row0):
    """K7's launch, or ValueError (module docstring)."""
    _check_instance(x, offsets, mask, weight, row0)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    b, c, hw_rows, w = x.shape
    h = offsets.shape[2]
    for name, t in (("offsets", offsets), ("mask", mask), ("weight", weight)):
        check_tensor(name, t, dev, torch.float32)
    x_last = x.permute(0, 2, 3, 1).contiguous()
    out = torch.empty(b, c, h, w, dtype=torch.float32, device=dev)
    _prepare(dev.index)
    lib = load_library()
    rc = lib.mvster_deform_conv(x_last.data_ptr(), offsets.data_ptr(), mask.data_ptr(),
                                weight.data_ptr(), out.data_ptr(), b, c, h, w, hw_rows, row0,
                                torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, rc, "mvster_deform_conv")
    deform_conv.launches += 1
    return out


class _K7(torch.autograd.Function):
    """K7 forward; the backward recomputes the plain version from the saved
    inputs and returns its gradients."""

    @staticmethod
    def forward(ctx, x, offsets, mask, weight, row0):
        ctx.save_for_backward(x, offsets, mask, weight)
        ctx.row0 = row0
        return _launch(x, offsets, mask, weight, row0)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:4]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = deform_conv_plain(*inputs, ctx.row0)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if n else None for n in need), None)


def deform_conv(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """K7 or the plain version, by the dispatch rule (module docstring)."""
    if x.device.type == "cpu":
        return deform_conv_plain(x, offsets, mask, weight, row0)
    return _K7.apply(x, offsets, mask, weight, row0)


deform_conv.launches = 0
