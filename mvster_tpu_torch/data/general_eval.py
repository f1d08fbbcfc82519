"""Generic evaluation dataset, DTU test / custom scans (the port's copy of mvster_tpu.data.general_eval).

Full-res cam files divided to the quarter-res stage-2 basis, 192 uniform
depth samples, images snapped down to multiples of 64 within (max_h,
max_w), per-scene or per-sample resolution pinning (`fix_res`).
"""

from __future__ import annotations

import os

import numpy as np

from mvster_tpu_torch.data.common import (
    read_cam_file,
    read_image,
    read_pair_file,
    snap_resize,
    stage_projections,
)
from mvster_tpu_torch.data.registry import register_dataset

NUM_DEPTH_BINS = 192


@register_dataset("general_eval", "general_eval4")
class GeneralEvalDataset:
    def __init__(self, datapath, listfile, mode, nviews, interval_scale=1.06,
                 max_h=864, max_w=1152, fix_res=False, **_):
        assert mode == "test"
        self.datapath = datapath
        self.nviews = nviews
        self.max_h, self.max_w = max_h, max_w
        self.fix_res = fix_res
        self.fixed_wh: tuple[int, int] | None = None  # set on first sample if fix_res
        scans = listfile if not isinstance(listfile, str) else [listfile]
        self.interval_scale = {s: interval_scale for s in scans}
        self.metas = self._build_metas(scans)

    def _build_metas(self, scans):
        metas = []
        for scan in scans:
            pairs = read_pair_file(os.path.join(self.datapath, scan, "pair.txt"))
            for ref, srcs in pairs:
                if len(srcs) < self.nviews - 1:
                    srcs = srcs + [srcs[0]] * (self.nviews - 1 - len(srcs))
                metas.append((scan, ref, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, path, interval_scale):
        cam = read_cam_file(path)
        intr = cam.intrinsics.copy()
        intr[:2, :] /= 4.0  # full-res cams -> stage2 (quarter-res) basis
        fields = cam.depth_fields
        depth_min, depth_interval = fields[0], fields[1]
        if len(fields) >= 3:
            depth_max = depth_min + int(fields[2]) * depth_interval
            depth_interval = (depth_max - depth_min) / NUM_DEPTH_BINS
        depth_interval *= interval_scale
        return intr, cam.extrinsics.copy(), depth_min, depth_interval

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, projs = [], []
        depth_values = None
        sample_wh: tuple[int, int] | None = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, f"{scan}/images_post/{vid:08d}.jpg")
            if not os.path.exists(img_path):
                img_path = os.path.join(self.datapath, f"{scan}/images/{vid:08d}.jpg")
            cam_path = os.path.join(self.datapath, f"{scan}/cams/{vid:08d}_cam.txt")

            img = read_image(img_path)
            intr, extr, depth_min, depth_interval = self._read_cam(
                cam_path, self.interval_scale[scan]
            )
            img, intr = snap_resize(img, intr, self.max_h, self.max_w)

            if self.fix_res and self.fixed_wh is None:
                self.fixed_wh = img.shape[:2]
            pin = self.fixed_wh if self.fixed_wh is not None else sample_wh
            if i == 0 and pin is None:
                sample_wh = img.shape[:2]
                pin = sample_wh
            if img.shape[:2] != pin:
                import cv2

                sh, sw = pin
                intr[0, :] *= sw / img.shape[1]
                intr[1, :] *= sh / img.shape[0]
                img = cv2.resize(img, (sw, sh))

            imgs.append(img)
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            projs.append(proj)

            if i == 0:
                depth_values = (
                    depth_min
                    + depth_interval * np.arange(NUM_DEPTH_BINS, dtype=np.float32)
                )

        return {
            "imgs": np.stack(imgs),
            "proj_matrices": stage_projections(np.stack(projs), base_stage=2),
            "depth_values": depth_values.astype(np.float32),
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }
