"""Tanks & Temples inference dataset (intermediate/advanced splits); the port's copy of mvster_tpu.data.tanks.

Mirrors datasets/tanks.py: hard-coded scan lists, 1080->1024 vertical crop
with a cy-28 principal-point shift, full-res cams scaled to the stage-1 basis.
"""

from __future__ import annotations

import os

import numpy as np

from mvster_tpu_torch.data.common import read_cam_file, read_image, read_pair_file
from mvster_tpu_torch.data.registry import register_dataset

INTERMEDIATE = [
    "Family", "Francis", "Horse", "Playground", "Train", "Lighthouse", "M60",
    "Panther",
]
ADVANCED = ["Auditorium", "Ballroom", "Courtroom", "Museum", "Palace", "Temple"]


@register_dataset("tanks")
class TanksDataset:
    def __init__(self, datapath, n_views=7, split="intermediate", **_):
        self.datapath = datapath
        self.split = split
        self.n_views = n_views
        self.scans = INTERMEDIATE if split == "intermediate" else ADVANCED
        self.metas = self._build_metas()

    def _build_metas(self):
        metas = []
        for scan in self.scans:
            pairs = read_pair_file(
                os.path.join(self.datapath, self.split, scan, "pair.txt")
            )
            for ref, srcs in pairs:
                metas.append((scan, ref, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.n_views - 1]

        imgs, projs = [], []
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(
                self.datapath, self.split, scan, f"images/{vid:08d}.jpg"
            )
            cam_path = os.path.join(
                self.datapath, self.split, scan, f"cams/{vid:08d}_cam.txt"
            )
            img = read_image(img_path)
            cam = read_cam_file(cam_path)
            intr = cam.intrinsics.copy()
            # 1080 -> 1024 crop: drop 28 rows top+bottom, shift principal point
            intr[1, 2] -= 28
            img = img[28 : img.shape[0] - 28]
            imgs.append(img)

            intr[:2, :] *= 0.125  # stage-1 basis
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = cam.extrinsics
            proj[1, :3, :3] = intr
            projs.append(proj)

            if i == 0:
                depth_min = cam.depth_fields[0]
                depth_max = cam.depth_fields[-1]

        stages = {}
        proj_stack = np.stack(projs)
        for s in range(1, 5):
            p = proj_stack.copy()
            p[:, 1, :2, :] *= 2.0 ** (s - 1)
            stages[f"stage{s}"] = p

        return {
            "imgs": np.stack(imgs),
            "proj_matrices": stages,
            "depth_values": np.array([depth_min, depth_max], np.float32),
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }
