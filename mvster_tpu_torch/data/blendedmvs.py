"""BlendedMVS fine-tune dataset (the port's copy of mvster_tpu.data.blendedmvs).

Mirrors datasets/blendedmvs.py: 768x576 images, per-scan depth normalization
(scale_factor = 100/depth_min applied to the range, translations, and GT),
full-res cams scaled by 1/8 to the stage-1 basis, robust training with random
source sampling + U(0.8, 1.25) metric scale.
"""

from __future__ import annotations

import os

import numpy as np

from mvster_tpu_torch.data.common import (
    nearest_resize,
    read_cam_file,
    read_image,
    read_pair_file,
    sample_rng,
)
from mvster_tpu_torch.data.pfm import read_pfm
from mvster_tpu_torch.data.registry import register_dataset


@register_dataset("blendedmvs")
class BlendedMVSDataset:
    def __init__(self, datapath, listfile, split, nviews, img_wh=(768, 576),
                 robust_train=True, seed=None, **_):
        assert split in ("train", "val", "all")
        if img_wh is not None:
            assert img_wh[0] % 32 == 0 and img_wh[1] % 32 == 0
        self.datapath = datapath
        self.nviews = nviews
        self.img_wh = img_wh
        self.robust_train = robust_train
        self.seed = seed
        self.epoch = 0
        self.scale_factors: dict[str, float] = {}
        self.metas = self._build_metas(listfile)

    def set_epoch(self, epoch: int):
        """Advance the per-sample augmentation RNG stream (see sample_rng)."""
        self.epoch = epoch

    def _build_metas(self, listfile):
        with open(listfile) as f:
            scans = [ln.rstrip() for ln in f if ln.strip()]
        metas = []
        for scan in scans:
            pairs = read_pair_file(os.path.join(self.datapath, scan, "cams/pair.txt"))
            for ref, srcs in pairs:
                if len(srcs) >= self.nviews - 1:
                    metas.append((scan, ref, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, scan, path):
        cam = read_cam_file(path)
        depth_min = cam.depth_fields[0]
        depth_max = cam.depth_fields[-1]
        if scan not in self.scale_factors:
            self.scale_factors[scan] = 100.0 / depth_min
        sf = self.scale_factors[scan]
        extr = cam.extrinsics.copy()
        extr[:3, 3] *= sf
        return cam.intrinsics.copy(), extr, depth_min * sf, depth_max * sf

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        if self.robust_train:
            rng = sample_rng(self.seed, self.epoch, idx)
            chosen = rng.sample(range(len(src_views)), self.nviews - 1)
            view_ids = [ref_view] + [src_views[i] for i in chosen]
            scale = rng.uniform(0.8, 1.25)
        else:
            view_ids = [ref_view] + src_views[: self.nviews - 1]
            scale = 1.0

        imgs, projs = [], []
        depth_ms = mask_ms = None
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, f"{scan}/blended_images/{vid:08d}.jpg")
            depth_path = os.path.join(
                self.datapath, f"{scan}/rendered_depth_maps/{vid:08d}.pfm"
            )
            cam_path = os.path.join(self.datapath, f"{scan}/cams/{vid:08d}_cam.txt")

            imgs.append(read_image(img_path))
            intr, extr, dmin, dmax = self._read_cam(scan, cam_path)
            extr[:3, 3] *= scale
            intr = intr.copy()
            intr[:2, :] *= 0.125  # stage-1 basis

            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            projs.append(proj)

            if i == 0:
                depth_min, depth_max = dmin * scale, dmax * scale
                depth_ms, mask_ms = self._read_depth_mask(
                    scan, depth_path, depth_min, depth_max, scale
                )

        stages = {}
        proj_stack = np.stack(projs)
        for s in range(1, 5):
            p = proj_stack.copy()
            p[:, 1, :2, :] *= 2.0 ** (s - 1)
            stages[f"stage{s}"] = p

        return {
            "imgs": np.stack(imgs),
            "proj_matrices": stages,
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": np.array([depth_min, depth_max], np.float32),
        }

    def _read_depth_mask(self, scan, path, depth_min, depth_max, scale):
        depth = read_pfm(path)[0] * self.scale_factors[scan] * scale
        mask = ((depth >= depth_min) & (depth <= depth_max)).astype(np.float32)
        assert mask.sum() > 0, f"empty valid mask for {path}"
        if self.img_wh is not None:
            depth = nearest_resize(depth, self.img_wh[1], self.img_wh[0])
            mask = nearest_resize(mask, self.img_wh[1], self.img_wh[0])
        h, w = depth.shape
        depth_ms, mask_ms = {}, {}
        for i in range(4):
            depth_ms[f"stage{4 - i}"] = nearest_resize(depth, h // 2**i, w // 2**i)
            mask_ms[f"stage{4 - i}"] = nearest_resize(mask, h // 2**i, w // 2**i)
        return depth_ms, mask_ms
