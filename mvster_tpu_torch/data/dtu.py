"""DTU training/val dataset, Yao Yao preprocessing (the port's copy of mvster_tpu.data.dtu).

Scene list x 49 viewpoints x 7 light conditions; quarter-res cam files
(stage-2 basis); mid mode = nearest half-downsample + 512x640 centre crop
of the raw GT maps (images ship pre-sized); raw mode = 1024x1280 centre
crop with intrinsics doubled; robust training (`rt`) = random source-view
sampling + a global metric scale in U(0.8, 1.25) applied to translations,
GT depth and the depth range.
"""

from __future__ import annotations

import os
import numpy as np

from mvster_tpu_torch.data.common import (
    center_crop,
    color_jitter,
    nearest_resize,
    read_cam_file,
    read_image,
    read_pair_file,
    sample_rng,
    stage_projections,
    stage_pyramid,
)
from mvster_tpu_torch.data.pfm import read_pfm
from mvster_tpu_torch.data.registry import register_dataset

NUM_DEPTH_BINS = 192  # DTU's canonical hypothesis count (dtu_yao4.py:16)


@register_dataset("dtu", "dtu_yao4")
class DTUDataset:
    def __init__(self, datapath, listfile, mode, nviews, interval_scale=1.06,
                 rt=False, use_raw_train=False, seed=None, **_):
        assert mode in ("train", "val", "test")
        self.datapath = datapath
        self.mode = mode
        self.nviews = nviews
        self.interval_scale = interval_scale
        self.rt = rt
        self.use_raw_train = use_raw_train
        self.seed = seed
        self.epoch = 0
        self.metas = self._build_metas(listfile)

    def set_epoch(self, epoch: int):
        """Advance the per-sample augmentation RNG stream (see sample_rng)."""
        self.epoch = epoch

    def _build_metas(self, listfile):
        with open(listfile) as f:
            scans = [ln.rstrip() for ln in f if ln.strip()]
        pair_path = os.path.join(self.datapath, "Cameras/pair.txt")
        pairs = read_pair_file(pair_path)
        metas = []
        for scan in scans:
            for ref, srcs in pairs:
                for light in range(7):
                    metas.append((scan, light, ref, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    def _prepare_map(self, hr: np.ndarray) -> np.ndarray:
        """Raw-res GT map -> training crop (mid: /2 + 512x640; raw: 1024x1280)."""
        h, w = hr.shape[:2]
        if self.use_raw_train:
            return center_crop(hr, 1024, 1280)
        ds = nearest_resize(hr, h // 2, w // 2)
        return center_crop(ds, 512, 640)

    def __getitem__(self, idx):
        scan, light, ref_view, src_views = self.metas[idx]
        rng = sample_rng(self.seed, self.epoch, idx)

        if self.mode == "train" and self.rt:
            chosen = rng.sample(range(len(src_views)), self.nviews - 1)
            view_ids = [ref_view] + [src_views[i] for i in chosen]
            scale = rng.uniform(0.8, 1.25)
        else:
            view_ids = [ref_view] + src_views[: self.nviews - 1]
            scale = 1.0

        imgs, projs = [], []
        depth_ms = mask_ms = depth_values = None
        for i, vid in enumerate(view_ids):
            if self.use_raw_train:
                img_path = os.path.join(
                    self.datapath,
                    f"Rectified_raw/{scan}/rect_{vid + 1:03d}_{light}_r5000.png",
                )
            else:
                img_path = os.path.join(
                    self.datapath,
                    f"Rectified/{scan}_train/rect_{vid + 1:03d}_{light}_r5000.png",
                )
            cam_path = os.path.join(self.datapath, f"Cameras/train/{vid:08d}_cam.txt")

            if self.mode == "train":
                img = color_jitter(img_path, rng)
            else:
                img = read_image(img_path)
            if self.use_raw_train:
                img = center_crop(img, 1024, 1280)

            cam = read_cam_file(cam_path)
            extr = cam.extrinsics.copy()
            intr = cam.intrinsics.copy()
            depth_min = cam.depth_fields[0]
            depth_interval = cam.depth_fields[1] * self.interval_scale
            if self.rt:
                extr[:3, 3] *= scale
            if self.use_raw_train:
                intr[:2, :] *= 2.0

            if i == 0:
                mask_path = os.path.join(
                    self.datapath, f"Depths_raw/{scan}/depth_visual_{vid:04d}.png"
                )
                depth_path = os.path.join(
                    self.datapath, f"Depths_raw/{scan}/depth_map_{vid:04d}.pfm"
                )
                mask_hr = (np.asarray(read_image(mask_path)) > 10 / 255.0).astype(
                    np.float32
                )
                mask_ms = stage_pyramid(self._prepare_map(mask_hr))
                depth_hr = read_pfm(depth_path)[0] * scale
                depth_ms = stage_pyramid(self._prepare_map(depth_hr))
                depth_max = depth_interval * NUM_DEPTH_BINS + depth_min
                depth_values = np.array(
                    [depth_min * scale, depth_max * scale], np.float32
                )

            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            projs.append(proj)
            imgs.append(img)

        return {
            "imgs": np.stack(imgs),  # (V, H, W, 3)
            "proj_matrices": stage_projections(np.stack(projs), base_stage=2),
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values,
        }
