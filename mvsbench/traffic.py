"""The one generator of inputs: a traffic file's parameters and a seed give
a pool of samples, the same pool for the same seed.

A sample is what the system's datasets yield: imgs (V, H, W, 3) in [0, 1],
proj_matrices {stage1..stage4: (V, 2, 4, 4)} (extrinsic, intrinsic scaled
to the stage's resolution H/8 .. H), depth_values (2,) the scene's range;
with `gt`, depth and mask {stage: (H_s, W_s)}: depths uniform inside the
range's inner 94% and a share `mask_share` of valid pixels.  The camera
rig: the reference view at the origin, each source view turned by up to
`max_angle` radians about each axis and moved by up to `max_shift` along
each, focal length `focal_scale` times the width (a frozen copy of the
synthetic rig of the repository's tests).  Every seed gives every sample
the same sizes; only the values differ.

Traffic keys: driver, height, width, views, batch, pool, depth_range,
focal_scale, max_angle, max_shift, gt, mask_share, and the driver's own
(warmup, trace_after, trace_count, check_views).
"""

from __future__ import annotations

import numpy as np


def _rotation(angles):
    cx, cy, cz = np.cos(angles)
    sx, sy, sz = np.sin(angles)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def sample(rng: np.random.Generator, t: dict) -> dict:
    h, w, v = t["height"], t["width"], t["views"]
    focal = t["focal_scale"] * w
    proj = np.zeros((v, 2, 4, 4), np.float32)
    for vi in range(v):
        extr = np.eye(4, dtype=np.float32)
        if vi:
            extr[:3, :3] = _rotation(rng.uniform(-t["max_angle"], t["max_angle"], 3))
            extr[:3, 3] = rng.uniform(-t["max_shift"], t["max_shift"], 3)
        proj[vi, 0] = extr
        proj[vi, 1, :3, :3] = [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]]
    stages = {}
    for s, scale in enumerate((0.125, 0.25, 0.5, 1.0), 1):
        p = proj.copy()
        p[:, 1, :2, :] *= scale
        stages[f"stage{s}"] = p
    lo, hi = t["depth_range"]
    out = {"imgs": rng.random((v, h, w, 3), dtype=np.float32),
           "proj_matrices": stages,
           "depth_values": np.array([lo, hi], np.float32)}
    if t.get("gt"):
        margin = 0.03 * (hi - lo)
        out["depth"], out["mask"] = {}, {}
        for s, down in enumerate((8, 4, 2, 1), 1):
            hs, ws = h // down, w // down
            out["depth"][f"stage{s}"] = rng.uniform(lo + margin, hi - margin,
                                                    (hs, ws)).astype(np.float32)
            out["mask"][f"stage{s}"] = (rng.random((hs, ws)) < t["mask_share"]).astype(
                np.float32)
    return out


def pool(t: dict, seed: int) -> list[dict]:
    """The traffic's `pool` distinct samples for this seed."""
    rng = np.random.default_rng(seed)
    return [sample(rng, t) for _ in range(t["pool"])]
