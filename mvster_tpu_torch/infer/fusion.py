"""Geometric-consistency filtering and point-cloud fusion on the device (counterpart of mvster_tpu.infer.fusion).

For one reference view: project its depth map into each source view,
sample the source depth bilinearly, reproject back and count the sources
that agree, as the reference does per pixel with numpy and cv2.remap
(test_mvs4.py:273-455).  A source agrees at a pixel when the reprojection
lands within dist_thresh (1 px) of it and its depth within rel_depth_thresh
(0.01) relative difference (test_mvs4.py:313-328).  final = confidence >
conf AND at least thres_view agreeing sources; the fused depth is the mean
of the agreeing reprojections and the reference estimate.

All S source views run as one batch on the device of the input tensors,
where the JAX package vmaps over them.  Every matrix product, over the
pixels too, is core.geometry's `_matmul`: a chain of float32 fused
multiply-adds over k, each formed exactly in float64 and rounded once to
float32, which is the JAX package's HIGHEST-precision matmul on the CPU bit
for bit; the closed-form inverses are core.geometry's and the sampler
core.sampling's.  So the card, the CPU and the JAX package compute the same
reprojections.  (With cuBLAS's float32 matmul the card's sums run in
another order: x and y move by ~1e-4 px, and where the depth map steps
that moves a source's sampled depth enough to flip its mask far from a
threshold.)  `unproject_to_world` stays numpy float64 on the host, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from mvster_tpu_torch.core.geometry import _matmul, inverse_3x3, inverse_affine_4x4
from mvster_tpu_torch.core.sampling import grid_sample_zeros


def _pixel_grid(h: int, w: int, like: torch.Tensor):
    ys = torch.arange(h, dtype=like.dtype, device=like.device)
    xs = torch.arange(w, dtype=like.dtype, device=like.device)
    return torch.meshgrid(ys, xs, indexing="ij")  # gy, gx: (H, W)


def _reproject(ref_depth, ref_intr, ref_extr, src_depths, src_intrs, src_extrs):
    """Project reference pixels into each source, sample its depth, reproject back.

    ref_depth (H, W), ref_intr (3, 3), ref_extr (4, 4); src_depths (S, H, W),
    src_intrs (S, 3, 3), src_extrs (S, 4, 4).  Returns (depth_reprojected,
    x_reprojected, y_reprojected), each (S, H, W).
    """
    s = src_depths.shape[0]
    h, w = ref_depth.shape
    gy, gx = _pixel_grid(h, w, ref_depth)
    pix = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, h * w)

    # reference pixel -> reference camera -> source camera -> source pixel
    cam_ref = _matmul(inverse_3x3(ref_intr), pix) * ref_depth.reshape(1, h * w)
    ref_to_src = _matmul(src_extrs, inverse_affine_4x4(ref_extr))
    cam_src = _matmul(ref_to_src[:, :3, :3], cam_ref) + ref_to_src[:, :3, 3:4]
    pix_src = _matmul(src_intrs, cam_src)
    xy_src = pix_src[:, :2] / pix_src[:, 2:3]  # (S, 2, HW)

    # the source depth at the projected locations (bilinear, zero padding)
    sampled = grid_sample_zeros(src_depths[..., None], xy_src[:, 0], xy_src[:, 1])[..., 0]

    # source pixel and sampled depth -> source camera -> reference camera -> pixel
    xy1 = torch.cat([xy_src, torch.ones_like(xy_src[:, :1])], dim=1)
    cam_src2 = _matmul(inverse_3x3(src_intrs), xy1) * sampled.reshape(s, 1, h * w)
    src_to_ref = _matmul(ref_extr, inverse_affine_4x4(src_extrs))
    cam_ref2 = _matmul(src_to_ref[:, :3, :3], cam_src2) + src_to_ref[:, :3, 3:4]
    depth_reproj = cam_ref2[:, 2].reshape(s, h, w)
    pix_ref2 = _matmul(ref_intr, cam_ref2)
    xy_ref2 = pix_ref2[:, :2] / pix_ref2[:, 2:3]
    return depth_reproj, xy_ref2[:, 0].reshape(s, h, w), xy_ref2[:, 1].reshape(s, h, w)


def reprojection_errors(ref_depth, ref_intr, ref_extr, src_depths, src_intrs, src_extrs):
    """Per source and pixel: (reprojected depth, reprojection distance in
    px, relative depth difference), each (S, H, W); what the filter's two
    thresholds are held against."""
    depth_reproj, x2, y2 = _reproject(
        ref_depth, ref_intr, ref_extr, src_depths, src_intrs, src_extrs)
    gy, gx = _pixel_grid(*ref_depth.shape, ref_depth)
    dist = torch.sqrt((x2 - gx) ** 2 + (y2 - gy) ** 2)
    rel = torch.abs(depth_reproj - ref_depth) / ref_depth
    return depth_reproj, dist, rel


def _check_sources(ref_depth, ref_intr, ref_extr, src_depths, src_intrs, src_extrs,
                   dist_thresh, rel_depth_thresh):
    """The JAX package's _check_one_src over all S sources at once: the
    (S, H, W) inlier masks and the inliers' reprojected depths (0 elsewhere)."""
    depth_reproj, dist, rel = reprojection_errors(
        ref_depth, ref_intr, ref_extr, src_depths, src_intrs, src_extrs)
    mask = (dist < dist_thresh) & (rel < rel_depth_thresh)
    return mask, torch.where(mask, depth_reproj, torch.zeros_like(depth_reproj))


def geometric_filter(
    ref_depth: torch.Tensor,
    ref_conf: torch.Tensor,
    ref_intr: torch.Tensor,
    ref_extr: torch.Tensor,
    src_depths: torch.Tensor,
    src_intrs: torch.Tensor,
    src_extrs: torch.Tensor,
    conf_thresh: float = 0.5,
    thres_view: int = 4,
    dist_thresh: float = 1.0,
    rel_depth_thresh: float = 0.01,
):
    """Cross-view consistency filter for one reference view.

    src_depths: (S, H, W); src_intrs: (S, 3, 3); src_extrs: (S, 4, 4), on
    the device of ref_depth.  Returns (final_mask (H, W) bool, fused_depth
    (H, W), geo_mask, photo_mask).
    """
    masks, reprojs = _check_sources(ref_depth, ref_intr, ref_extr, src_depths,
                                    src_intrs, src_extrs, dist_thresh, rel_depth_thresh)
    geo_count = masks.sum(dim=0, dtype=torch.int32)
    # the sources summed in order, one rounding an add, on every device (a
    # reduction kernel may pair them otherwise)
    total = reprojs[0]
    for r in reprojs[1:]:
        total = total + r
    depth_avg = (total + ref_depth) / (geo_count.to(ref_depth.dtype) + 1.0)
    geo_mask = geo_count >= thres_view
    photo_mask = ref_conf > conf_thresh
    return geo_mask & photo_mask, depth_avg, geo_mask, photo_mask


def unproject_to_world(depth, mask, intr, extr, colors=None):
    """Masked pixels -> world-space points (numpy, float64, on the host).

    Mirrors the reference unprojection (test_mvs4.py:400-405).
    """
    depth = np.asarray(depth)
    mask = np.asarray(mask)
    h, w = depth.shape
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xs, ys, ds = gx[mask], gy[mask], depth[mask]
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=0).astype(np.float64)
    cam = np.linalg.inv(np.asarray(intr, np.float64)) @ (pix * ds)
    cam_h = np.concatenate([cam, np.ones_like(cam[:1])], axis=0)
    world = (np.linalg.inv(np.asarray(extr, np.float64)) @ cam_h)[:3]
    out_colors = None
    if colors is not None:
        out_colors = np.asarray(colors)[mask]
    return world.T.astype(np.float32), out_colors


def fuse_scene(
    pair_data,
    depths: dict[int, np.ndarray],
    confs: dict[int, np.ndarray],
    intrinsics: dict[int, np.ndarray],
    extrinsics: dict[int, np.ndarray],
    images: dict[int, np.ndarray] | None = None,
    conf_thresh: float = 0.5,
    thres_view: int = 4,
    *,
    device: torch.device | str,
):
    """Fuse all reference views of one scene into a world point cloud.

    pair_data: [(ref_view, [src_views...])].  `device` has no default: the
    caller names the card or the CPU (tools.test passes what
    tools.cli.resolve_device gives).  Each view's depth map, confidence and
    cameras go to `device` once; per reference view only
    final, depth_avg and the two masks come back.  Returns (xyz (N, 3),
    rgb | None, per-view masks {view: {"final", "geo", "photo"}}).
    """
    def put(arrays, v):
        return torch.from_numpy(np.ascontiguousarray(arrays[v], np.float32)).to(device)

    views = sorted({v for ref, srcs in pair_data for v in [ref, *srcs]})
    on_dev = {v: (put(depths, v), put(confs, v), put(intrinsics, v), put(extrinsics, v))
              for v in views}
    all_xyz, all_rgb = [], []
    view_masks = {}
    for ref_view, src_views in pair_data:
        depth, conf, intr, extr = on_dev[ref_view]
        src_d, _, src_k, src_e = (torch.stack(x) for x in zip(*(on_dev[v] for v in src_views)))
        final, depth_avg, geo_mask, photo_mask = (
            x.cpu().numpy() for x in geometric_filter(
                depth, conf, intr, extr, src_d, src_k, src_e,
                conf_thresh=conf_thresh, thres_view=thres_view))
        view_masks[ref_view] = {"final": final, "geo": geo_mask, "photo": photo_mask}
        colors = images[ref_view] if images is not None else None
        xyz, rgb = unproject_to_world(
            depth_avg, final, intrinsics[ref_view], extrinsics[ref_view], colors)
        all_xyz.append(xyz)
        if rgb is not None:
            all_rgb.append((rgb * 255).astype(np.uint8) if rgb.dtype != np.uint8 else rgb)

    xyz = np.concatenate(all_xyz, axis=0) if all_xyz else np.zeros((0, 3), np.float32)
    rgb = np.concatenate(all_rgb, axis=0) if all_rgb else None
    return xyz, rgb, view_masks
