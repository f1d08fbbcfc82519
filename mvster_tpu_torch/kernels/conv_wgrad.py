"""The weight gradient of a planar (1, 3, 3) convolution: K6, a CUDA kernel.

`conv_wgrad(g, x, stride, padding)` computes

  dW[m, c, 0, kh, kw] = sum over b, d, y, x of
      g[b, m, d, y, x] * x[b, c, d, y * stride + kh - ph, x * stride + kw - pw]

with x zero outside its H x W: the weight gradient of a Conv3d with kernel
(1, 3, 3), stride (1, s, s) and padding (0, ph, pw) (g its output gradient,
x its input), and of a ConvTranspose3d of the same kernel, stride and
padding with the roles swapped (g its input, x its output gradient, any
output padding).  g is (B, M, D, Ho, Wo), x (B, C, D, Hi, Wi) with
Ho = (Hi + 2 ph - 3) // s + 1 (and Wo alike); the result is (M, C, 1, 3, 3).

K6 (csrc/conv_wgrad.cu mvster_conv_wgrad) replaces no TPU kernel: the JAX
package leaves this gradient to XLA.  It was added because cuDNN's float32
weight gradient at Reg2d's shapes (wgrad2d_grouped_direct) runs at about
0.1% of the H100's FP32 peak.  Its bound, ~15 GFLOP of FFMA over ~0.8 GB a
DTU-mid train step (0.22 ms and 0.24 ms at 67 TFLOP/s and 3.35 TB/s), and
its design (persistent blocks over tiles of output pixels staged by
cp.async, register blocks of dW, a deterministic sum over the blocks'
partials) are in the source's note.

A CPU tensor takes the plain version, `conv_wgrad_plain` (the taps by
strided slices of the zero-padded x, one matrix product a tile, the tiles'
products summed a block and the blocks in order, as the kernel groups its
partial sums); a CUDA tensor launches K6 or raises.  K6 has instances for
stride 1 with (M, C) = (8, 4), (8, 8) and stride 2 with (16, 8), (32, 16),
(64, 32): Reg2d's planar blocks at base 8 after 4 or 8 correlation
groups (`supported`).  `conv_wgrad.launches` counts launches of its main
kernel.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mvster_tpu_torch.kernels._build import load_library, raise_on_error

# (stride, M, C) -> the kernel's tile of output pixels (rows, columns):
# 8 pixels a thread of each pixel group, at least 32 (csrc Plan).
TILES = {
    (1, 8, 4): (8, 64),
    (1, 8, 8): (4, 64),
    (2, 16, 8): (2, 64),
    (2, 32, 16): (1, 32),
    (2, 64, 32): (1, 32),
}
BLOCKS_PER_SM = 2
SCRATCH_BYTES = 16 << 20  # the blocks' partials, at most


def supported(stride: int, m: int, c: int) -> bool:
    """Whether K6 has an instance for this stride and (M, C)."""
    return (stride, m, c) in TILES


def _out_size(n_in: int, stride: int, pad: int) -> int:
    return (n_in + 2 * pad - 3) // stride + 1


def _check_shapes(g, x, stride, padding):
    if g.dim() != 5 or x.dim() != 5:
        raise ValueError(f"g and x must be (B, C, D, H, W), got {tuple(g.shape)}, {tuple(x.shape)}")
    if stride not in (1, 2) or any(p not in (0, 1) for p in padding):
        raise ValueError(f"no planar weight gradient for stride {stride}, padding {padding}")
    (b, _, d, ho, wo), (bx, _, dx, hi, wi) = g.shape, x.shape
    want = (_out_size(hi, stride, padding[0]), _out_size(wi, stride, padding[1]))
    if (b, d) != (bx, dx) or (ho, wo) != want:
        raise ValueError(f"g {tuple(g.shape)} is not the output of x {tuple(x.shape)} "
                         f"at stride {stride}, padding {padding}: (Ho, Wo) must be {want}")


def conv_wgrad_plain(g: torch.Tensor, x: torch.Tensor, stride: int,
                     padding=(1, 1), blocks: int = 1) -> torch.Tensor:
    """The weight gradient by unfold and matmul: one (M, C * 9) product a
    tile of output pixels (K6's tile where it has an instance, else the
    plane), the tiles summed a block (tile t goes to block t % blocks) and
    the blocks in order."""
    _check_shapes(g, x, stride, padding)
    b, m, d, ho, wo = g.shape
    c, hi, wi = x.shape[1], x.shape[3], x.shape[4]
    ph, pw = padding
    ty, tx = TILES.get((stride, m, c), (ho, wo))
    nty, ntx = -(-ho // ty), -(-wo // tx)
    hp, wp = nty * ty, ntx * tx
    xp = F.pad(x, (pw, max(0, (wp - 1) * stride + 3 - pw - wi),
                   ph, max(0, (hp - 1) * stride + 3 - ph - hi)))
    taps = torch.stack([xp[..., kh:kh + (hp - 1) * stride + 1:stride,
                           kw:kw + (wp - 1) * stride + 1:stride]
                        for kh in range(3) for kw in range(3)], 2)  # (B, C, 9, D, hp, wp)
    gp = F.pad(g, (0, wp - wo, 0, hp - ho))

    def tiles(t, ch):  # (B, ch, D, hp, wp) -> (tiles, ch, pixels), tiles in K6's order
        t = t.reshape(b, ch, d, nty, ty, ntx, tx).permute(0, 2, 3, 5, 1, 4, 6)
        return t.reshape(-1, ch, ty * tx)

    per_tile = torch.bmm(tiles(gp, m), tiles(taps.reshape(b, c * 9, d, hp, wp), c * 9)
                         .transpose(1, 2)).reshape(-1, m * c * 9)
    nb = min(blocks, per_tile.shape[0])
    per_tile = F.pad(per_tile, (0, 0, 0, -per_tile.shape[0] % nb))
    dw = per_tile.reshape(-1, nb, m * c * 9).sum(0).sum(0)
    return dw.reshape(m, c, 1, 3, 3)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_blocks(g_shape, c: int, stride: int, device: torch.device) -> int:
    """K6's persistent blocks: two an SM, no more than its tiles, and no
    more partials than SCRATCH_BYTES hold."""
    b, m, d, ho, wo = g_shape
    ty, tx = TILES[(stride, m, c)]
    ntiles = b * d * -(-ho // ty) * -(-wo // tx)
    cap = SCRATCH_BYTES // (m * c * 9 * 4)
    return max(1, min(BLOCKS_PER_SM * _sm_count(device.index or 0), ntiles, cap))


def conv_wgrad(g: torch.Tensor, x: torch.Tensor, stride: int, padding=(1, 1)) -> torch.Tensor:
    """K6: the planar conv's weight gradient, (M, C, 1, 3, 3) (module docstring)."""
    padding = tuple(int(p) for p in padding)
    if g.device.type == "cpu":
        return conv_wgrad_plain(g, x, stride, padding)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    _check_shapes(g, x, stride, padding)
    for name, t in (("g", g), ("x", x)):
        if t.device != g.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {g.device}, got {t.dtype} on {t.device}")
    b, m, d, ho, wo = g.shape
    c, hi, wi = x.shape[1], x.shape[3], x.shape[4]
    if not supported(stride, m, c):
        raise ValueError(f"K6 has no instance for stride {stride}, (M, C) = ({m}, {c}); "
                         f"it has {sorted(TILES)}")
    blocks = plan_blocks(tuple(g.shape), c, stride, g.device)
    part = torch.empty(blocks, m * c * 9, dtype=torch.float32, device=g.device)
    dw = torch.empty(m, c, 1, 3, 3, dtype=torch.float32, device=g.device)
    lib = load_library()
    ty, tx = TILES[(stride, m, c)]
    rc = lib.mvster_conv_wgrad(g.data_ptr(), x.data_ptr(), part.data_ptr(), dw.data_ptr(),
                               b, d, m, c, stride, ho, wo, hi, wi, *padding,
                               *g.stride(), *x.stride(), ty, tx, blocks,
                               torch.cuda.current_stream(g.device).cuda_stream)
    raise_on_error(lib, rc, "mvster_conv_wgrad")
    conv_wgrad.launches += 1
    return dw


conv_wgrad.launches = 0

