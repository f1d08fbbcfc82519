"""The training warp: a bilinear gather whose forward and backward are CUDA kernels.

Counterpart of mvster_tpu.kernels.pallas_scatter.grid_sample_zeros_vjp.
`grid_sample_zeros_vjp(src, x, y)` is a torch.autograd.Function:

  forward   `warp_gather`  (K2, csrc/warp_scatter.cu mvster_warp_gather),
            which replaces pallas_warp.py::_warp_kernel in warp-only mode
  backward  `scatter_grad` (K3, mvster_warp_scatter), which replaces
            pallas_scatter.py::_scatter_kernel

The coordinates get no gradient (None), as the JAX package gives them zero
cotangents: in MVSTER they are functions of detached hypotheses and
constant cameras.  A CPU tensor takes the plain versions, `warp_plain`
(core.sampling.grid_sample_zeros) and `scatter_grad_plain` (an index_add_
transpose of the same four taps); a CUDA tensor launches the kernel or
raises.  `warp_gather.launches` and `scatter_grad.launches` count kernel
launches, so a run can show that its main path went through the kernels.

Layouts: src (B, Hs, Ws, C) channels-last; x, y (B, ...) raw pixel
coordinates; the warped output (B, ..., C).
"""

from __future__ import annotations

import torch

from mvster_tpu_torch.core.sampling import bilinear_taps, grid_sample_zeros
from mvster_tpu_torch.kernels._build import check_tensor, load_library, raise_on_error

warp_plain = grid_sample_zeros


def scatter_grad_plain(cot: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       src_shape) -> torch.Tensor:
    """dL/dsrc of warp_plain(src, x, y) for the cotangent cot (B, ..., C):
    each tap's weighted cotangent index_add_-ed into a zero (B, Hs, Ws, C)."""
    b, h, w, c = src_shape
    x = x.reshape(b, -1)
    y = y.reshape(b, -1)
    cot = cot.reshape(b, -1, c)
    base = (torch.arange(b, device=cot.device) * (h * w)).view(b, 1)
    dsrc = torch.zeros(b * h * w, c, dtype=cot.dtype, device=cot.device)
    for flat, weight in bilinear_taps(x, y, h, w):
        dsrc.index_add_(0, (flat + base).reshape(-1),
                        (cot * weight[..., None]).reshape(-1, c))
    return dsrc.reshape(b, h, w, c)


def _launch(fn_name, data, x, y, out, src_shape):
    """Launch mvster_warp_gather or mvster_warp_scatter on the current stream."""
    lib = load_library()
    b, h, w, c = src_shape
    n = x.numel() // b
    vec4 = int(c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (data, out)))
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn_name)(data.data_ptr(), x.data_ptr(), y.data_ptr(),
                                   out.data_ptr(), b, n, h, w, c, vec4, stream)
    raise_on_error(lib, rc, fn_name)


def _check_coords(x, y, b, device):
    if x.shape != y.shape or x.dim() < 2 or x.shape[0] != b:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} must share "
                         f"one shape (B={b}, ...)")
    check_tensor("x", x, device, torch.float32)
    check_tensor("y", y, device, torch.float32)


def warp_gather(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K2: src (B, Hs, Ws, C) sampled at x, y (B, ...) -> (B, ..., C)."""
    if src.device.type == "cpu":
        return warp_plain(src, x, y)
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    if src.dim() != 4:
        raise ValueError(f"src must be (B, H, W, C), got {tuple(src.shape)}")
    check_tensor("src", src, src.device, torch.float32)
    _check_coords(x, y, src.shape[0], src.device)
    out = torch.empty(tuple(x.shape) + (src.shape[-1],), dtype=torch.float32,
                      device=src.device)
    _launch("mvster_warp_gather", src, x, y, out, tuple(src.shape))
    warp_gather.launches += 1
    return out


def scatter_grad(cot: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 src_shape) -> torch.Tensor:
    """K3: the gradient of warp_gather with respect to src, (B, Hs, Ws, C)."""
    src_shape = tuple(int(s) for s in src_shape)
    if cot.device.type == "cpu":
        return scatter_grad_plain(cot, x, y, src_shape)
    if cot.device.type != "cuda":
        raise ValueError(f"no kernel for device {cot.device}")
    if len(src_shape) != 4:
        raise ValueError(f"src_shape must be (B, H, W, C), got {src_shape}")
    _check_coords(x, y, src_shape[0], cot.device)
    check_tensor("cot", cot, cot.device, torch.float32, tuple(x.shape) + (src_shape[-1],))
    dsrc = torch.zeros(src_shape, dtype=torch.float32, device=cot.device)
    _launch("mvster_warp_scatter", cot, x, y, dsrc, src_shape)
    scatter_grad.launches += 1
    return dsrc


warp_gather.launches = 0
scatter_grad.launches = 0


class _GridSampleZerosVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, x, y):
        ctx.save_for_backward(x, y)
        ctx.src_shape = tuple(src.shape)
        return warp_gather(src, x, y)

    @staticmethod
    def backward(ctx, cot):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        x, y = ctx.saved_tensors
        return scatter_grad(cot.contiguous(), x, y, ctx.src_shape), None, None


def grid_sample_zeros_vjp(src: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """grid_sample_zeros with K2 forward and K3 backward; x, y get no gradient."""
    return _GridSampleZerosVJP.apply(src, x, y)
