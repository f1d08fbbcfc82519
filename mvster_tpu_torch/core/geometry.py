"""Projective geometry for plane-sweep stereo (counterpart of mvster_tpu.core.geometry).

Every projection in the pipeline is an affine 4x4 (last row [0, 0, 0, 1]),
so the inverse is the closed-form adjugate one, as in the JAX package.

Every matrix product here is written out as a chain of fused multiply-adds
over k = 0, 1, 2, ... (`_matmul`), which is bit for bit what the JAX
package's HIGHEST-precision matmul gives on the CPU; the plane-sweep
coordinates follow the same rule:

    ray_i = fma(rot[i, 1], y, rot[i, 0] * x) + rot[i, 2]
    p_i   = ray_i * depth + trans[i]          (separately rounded)
    x, y  = p_0 / z, p_1 / z                  (z == 0 -> 1e-9)

So the geometry gives the same bits on the CPU and on the GPU, whatever
library serves a matmul there, and the CUDA cost-volume kernel
(csrc/warp_correlate.cu) repeats the coordinate sequence with explicitly
rounded intrinsics: kernel and plain version sample the source features at
identical coordinates.  The fused multiply-add is formed in float64, where
the product of two float32 values is exact and one rounding to float32
remains (a second rounding step can only differ at an exact float32
midpoint).
"""

from __future__ import annotations

import torch


def inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    co00 = e * i - f * h
    co01 = f * g - d * i
    co02 = d * h - e * g
    det = a * co00 + b * co01 + c * co02

    adj = torch.stack(
        [
            torch.stack([co00, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([co01, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([co02, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding (the product is exact in float64);
    float64 inputs stay float64."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for small (..., M, K) @ (..., K, N) as an FMA chain over k."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = _fma(a[..., :, k:k + 1], b[..., k:k + 1, :], acc)
    return acc


def inverse_affine_4x4(m: torch.Tensor) -> torch.Tensor:
    """Inverse of affine (..., 4, 4) matrices: [[A, t], [0, 1]] -> [[A^-1, -A^-1 t], [0, 1]]."""
    a_inv = inverse_3x3(m[..., :3, :3])
    t = m[..., :3, 3:4]
    top = torch.cat([a_inv, -_matmul(a_inv, t)], dim=-1)  # (..., 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def compose_projection(proj_pair: torch.Tensor) -> torch.Tensor:
    """(..., 2, 4, 4) (extrinsic, intrinsic) -> (..., 4, 4) with [:3] = K @ E[:3]."""
    extr = proj_pair[..., 0, :, :]
    intr = proj_pair[..., 1, :3, :3]
    top = _matmul(intr, extr[..., :3, :4])
    return torch.cat([top, extr[..., 3:4, :]], dim=-2)


def plane_sweep_rt(
    src_proj: torch.Tensor, ref_proj: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Relative projection: rot (..., 3, 3) and trans (..., 3).

    The source coordinate of reference pixel (px, py) at depth d is
    (rot @ (px, py, 1)) * d + trans, divided by its z.
    """
    proj = _matmul(src_proj, inverse_affine_4x4(ref_proj))
    return proj[..., :3, :3], proj[..., :3, 3]


def plane_sweep_coords(
    src_proj: torch.Tensor,
    ref_proj: torch.Tensor,
    depth_values: torch.Tensor,
    row0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Source-view pixel coordinates for each reference pixel and hypothesis.

    src_proj, ref_proj: (B, 4, 4) composed projections; depth_values
    (B, D, H, W), the reference rows row0 .. row0 + H - 1 (a band of the
    image; the whole of it at row0 0).  Returns (x, y), each (B, D, H, W),
    in raw pixel units.
    """
    _, _, h, w = depth_values.shape
    rot, trans = plane_sweep_rt(src_proj, ref_proj)
    dev, dt = depth_values.device, depth_values.dtype
    xs = torch.arange(w, device=dev, dtype=dt).view(1, 1, w)
    ys = torch.arange(row0, row0 + h, device=dev, dtype=dt).view(1, h, 1)

    def ray(i):  # (B, 1, H, W)
        r0, r1, r2 = (rot[:, i, j].view(-1, 1, 1) for j in range(3))
        return (_fma(r1, ys, r0 * xs) + r2)[:, None]

    px, py, pz = (ray(i) * depth_values + trans[:, i].view(-1, 1, 1, 1)
                  for i in range(3))
    pz = torch.where(pz == 0.0, torch.full_like(pz, 1e-9), pz)
    return px / pz, py / pz
