"""The fused plane-sweep cost volume: CUDA kernel wrapper and its plain version.

`fused_cost_volume` computes `build_cost_volume(group_cor=True)` for one
cascade stage, all source views in one launch of the hand-written kernel in
csrc/warp_correlate.cu (which replaces the TPU kernel
mvster_tpu/kernels/pallas_warp.py::_warp_kernel and the view fusion of
fused_cost_volume_geom).  A CPU tensor takes the plain PyTorch version,
`fused_cost_volume_plain`; a CUDA tensor launches the kernel or raises.

The reference may be a band of image rows: `row0` is its first row in the
image, and the source maps (V, B, Hs, Ws, C) keep a size of their own
(dist/spatial.py runs each rank's band against whole sources).  With
row0 = 0 and sources of the reference's size the kernel computes what it
did before the band offset existed, bit for bit.

`fused_cost_volume.launches` counts kernel launches (`launch` adds one
per launch), so a run can show that its main path went through the kernel.
`plan_launch` decides, in Python, how the kernel maps threads to (pixel,
depth plane) pairs and which of its instances runs: any 1 <= D <= 256
and any G that divides C, G <= 64.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from mvster_tpu_torch.core.geometry import plane_sweep_rt
from mvster_tpu_torch.kernels.cost_volume import plain_cost_volume

THREADS = 256  # csrc/warp_correlate.cu kMaxThreads: P * D threads a block, at most
MAX_D = THREADS  # one block holds at least one pixel's D planes
CAPACITIES = (4, 8, 16, 32, 64)  # the kernel's MAXG instances
MAX_G = CAPACITIES[-1]


def fused_cost_volume_plain(ref_feat, src_feats, ref_proj, src_projs,
                            depth_hypo, group_dim, attn_temp, attn_fuse_d, row0=0):
    """Plain PyTorch version of the kernel, on any device."""
    return plain_cost_volume(
        ref_feat, src_feats, ref_proj, src_projs, depth_hypo,
        group_cor=True, group_dim=group_dim, attn_temp=attn_temp,
        attn_fuse_d=attn_fuse_d, row0=row0,
    )


class LaunchPlan(NamedTuple):
    """How K1 runs one stage (csrc/warp_correlate.cu)."""

    maxg: int     # the template capacity of the per-group arrays, >= G
    split: int    # groups a float4 load spans: 1 (C/G % 4 == 0), 2 (C/G == 2),
    #               4 (C/G == 1); 0 = scalar loads
    pixels: int   # reference pixels a block (P)
    threads: int  # P * D: one thread per (pixel, depth plane)
    smem: int     # dynamic shared bytes: the (D, P) logits of a view, twice


@functools.lru_cache(maxsize=None)
def plan_launch(d: int, c: int, g: int, vec4: bool = True) -> LaunchPlan:
    """K1's launch for D planes, C channels and G groups: P = 256 // D
    pixels a block (at least 1), float4 loads where C % 4 == 0 (and vec4,
    the pointers' alignment) and C/G is 1, 2 or a multiple of 4 (every G
    that divides the FPN's power-of-two widths), the smallest capacity
    that holds G.  Raises ValueError for D outside [1, 256], G outside
    [1, 64] or G not dividing C."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the CUDA cost-volume kernel takes 1 <= D <= {MAX_D} "
                         f"depth planes, got D={d}")
    if not 1 <= g <= MAX_G or c % g:
        raise ValueError(f"the CUDA cost-volume kernel takes 1 <= G <= {MAX_G} "
                         f"groups that divide C; got G={g}, C={c}")
    sub = c // g
    split = 0
    if vec4 and c % 4 == 0:
        split = 1 if sub % 4 == 0 else {1: 4, 2: 2}.get(sub, 0)
    pixels = max(1, THREADS // d)
    threads = pixels * d
    return LaunchPlan(next(m for m in CAPACITIES if g <= m), split, pixels, threads,
                      2 * threads * 4)


def _check_tensors(ref_feat, **tensors):
    for name, t in dict(ref_feat=ref_feat, **tensors).items():
        if t.device != ref_feat.device:
            raise ValueError(f"{name} is on {t.device}, ref_feat on {ref_feat.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")


def _check_kernel_inputs(ref_feat, src_feats, depth_hypo, rot, trans, group_dim):
    """Everything the kernel reads: device, dtype, contiguity and shapes."""
    _check_tensors(ref_feat, src_feats=src_feats, depth_hypo=depth_hypo,
                   rot=rot, trans=trans)
    named = dict(ref_feat=ref_feat, src_feats=src_feats, depth_hypo=depth_hypo,
                 rot=rot, trans=trans)
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref_feat.dim() != 4 or src_feats.dim() != 5 or depth_hypo.dim() != 4:
        raise ValueError(
            "expected ref_feat (B, H, W, C), src_feats (V, B, Hs, Ws, C), "
            f"depth_hypo (B, D, H, W); got {tuple(ref_feat.shape)}, "
            f"{tuple(src_feats.shape)}, {tuple(depth_hypo.shape)}"
        )
    b, h, w, c = ref_feat.shape
    v = src_feats.shape[0]
    d = depth_hypo.shape[1]
    if (v < 1 or src_feats.shape[1] != b or src_feats.shape[4] != c
            or min(src_feats.shape[2:4]) < 1):
        raise ValueError(f"src_feats {tuple(src_feats.shape)} does not match "
                         f"ref_feat {tuple(ref_feat.shape)}")
    if tuple(depth_hypo.shape) != (b, d, h, w):
        raise ValueError(f"depth_hypo {tuple(depth_hypo.shape)} does not match "
                         f"ref_feat {tuple(ref_feat.shape)}")
    if tuple(rot.shape) != (v, b, 3, 3) or tuple(trans.shape) != (v, b, 3):
        raise ValueError(f"rot {tuple(rot.shape)}, trans {tuple(trans.shape)} "
                         f"do not match V={v}, B={b}")
    plan_launch(d, c, group_dim)  # raises for a D or G the kernel does not take


def plane_sweep_rts(ref_proj, src_projs):
    """rot (V, B, 3, 3) and trans (V, B, 3) of every source view, contiguous.

    One broadcast call for all views; core.geometry's products are
    elementwise FMA chains, so each view's values are bit-identical to the
    per-view plane_sweep_rt that the plain version computes.
    """
    rot, trans = plane_sweep_rt(src_projs, ref_proj)
    return rot.contiguous(), trans.contiguous()


def launch(ref_feat, src_feats, depth_hypo, rot, trans, group_dim, attn_temp,
           attn_fuse_d, row0=0):
    """Check the inputs, launch the kernel on the current stream and return
    its (B, D, H, W, G) output; rot/trans as plane_sweep_rts gives them."""
    from mvster_tpu_torch.kernels._build import load_library, raise_on_error

    _check_kernel_inputs(ref_feat, src_feats, depth_hypo, rot, trans, group_dim)
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    lib = load_library()
    b, h, w, c = ref_feat.shape
    v, hs, ws = src_feats.shape[0], src_feats.shape[2], src_feats.shape[3]
    d = depth_hypo.shape[1]
    plan = plan_launch(d, c, group_dim,
                       ref_feat.data_ptr() % 16 == 0 and src_feats.data_ptr() % 16 == 0)
    out = torch.empty((b, d, h, w, group_dim), dtype=torch.float32,
                      device=ref_feat.device)
    with torch.cuda.device(ref_feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mvster_warp_correlate(
            ref_feat.data_ptr(), src_feats.data_ptr(), depth_hypo.data_ptr(),
            rot.data_ptr(), trans.data_ptr(), out.data_ptr(),
            b, v, d, h, w, hs, ws, int(row0), c, group_dim, int(bool(attn_fuse_d)),
            float(attn_temp), math.sqrt(c), plan.maxg, plan.split, plan.pixels,
            plan.threads, plan.smem, stream,
        )
    raise_on_error(lib, rc, "mvster_warp_correlate")
    fused_cost_volume.launches += 1
    return out


def fused_cost_volume(ref_feat, src_feats, ref_proj, src_projs, depth_hypo,
                      group_dim, attn_temp, attn_fuse_d, row0=0):
    """Attention-fused group-correlation volume (B, D, H, W, G).

    ref_feat (B, H, W, C), the reference rows row0 .. row0 + H - 1;
    src_feats (V, B, Hs, Ws, C), ref_proj (B, 4, 4), src_projs (V, B, 4, 4),
    depth_hypo (B, D, H, W); all float32, and all but the projections
    contiguous for the kernel.
    """
    if ref_feat.device.type == "cpu":
        return fused_cost_volume_plain(ref_feat, src_feats, ref_proj, src_projs,
                                       depth_hypo, group_dim, attn_temp,
                                       attn_fuse_d, row0)
    if ref_feat.device.type != "cuda":
        raise ValueError(f"no kernel for device {ref_feat.device}")
    _check_tensors(ref_feat, ref_proj=ref_proj, src_projs=src_projs)
    v, b = src_feats.shape[0], ref_feat.shape[0]
    if tuple(ref_proj.shape) != (b, 4, 4) or tuple(src_projs.shape) != (v, b, 4, 4):
        raise ValueError(f"projections {tuple(ref_proj.shape)}, "
                         f"{tuple(src_projs.shape)} do not match B={b}, V={v}")
    rot, trans = plane_sweep_rts(ref_proj, src_projs)
    return launch(ref_feat, src_feats, depth_hypo, rot, trans, group_dim,
                  attn_temp, attn_fuse_d, row0)


fused_cost_volume.launches = 0
