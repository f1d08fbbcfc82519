"""ETH3D high-res dataset (train/test splits); the port's copy of mvster_tpu.data.eth3d.

Mirrors datasets/eth3d.py: hard-coded scan lists, bilinear resize to
1920x1280 with intrinsic rescale, negative depth_min clamped to 1, cams from
the `cams_1` directory, stage-1 intrinsic basis.
"""

from __future__ import annotations

import os

import numpy as np

from mvster_tpu_torch.data.common import read_cam_file, read_image, read_pair_file
from mvster_tpu_torch.data.registry import register_dataset

TEST_SCANS = [
    "botanical_garden", "boulders", "bridge", "door", "exhibition_hall",
    "lecture_room", "living_room", "lounge", "observatory", "old_computer",
    "statue", "terrace_2",
]
TRAIN_SCANS = [
    "courtyard", "delivery_area", "electro", "facade", "kicker", "meadow",
    "office", "pipes", "playground", "relief", "relief_2", "terrace",
    "terrains",
]


@register_dataset("eth3d")
class ETH3DDataset:
    def __init__(self, datapath, split="test", n_views=7, img_wh=(1920, 1280), **_):
        self.datapath = datapath
        self.img_wh = img_wh
        self.n_views = n_views
        self.scans = TEST_SCANS if split == "test" else TRAIN_SCANS
        self.metas = self._build_metas()

    def _build_metas(self):
        metas = []
        for scan in self.scans:
            pairs = read_pair_file(os.path.join(self.datapath, scan, "pair.txt"))
            for ref, srcs in pairs:
                metas.append((scan, ref, srcs))
        return metas

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        import cv2

        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.n_views - 1]

        imgs, projs = [], []
        depth_min = depth_max = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, scan, f"images/{vid:08d}.jpg")
            cam_path = os.path.join(self.datapath, scan, f"cams_1/{vid:08d}_cam.txt")

            img = read_image(img_path)
            oh, ow = img.shape[:2]
            img = cv2.resize(img, self.img_wh, interpolation=cv2.INTER_LINEAR)
            cam = read_cam_file(cam_path)
            intr = cam.intrinsics.copy()
            intr[0] *= self.img_wh[0] / ow
            intr[1] *= self.img_wh[1] / oh
            imgs.append(img)

            intr[:2, :] *= 0.125
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = cam.extrinsics
            proj[1, :3, :3] = intr
            projs.append(proj)

            if i == 0:
                depth_min = 1.0 if cam.depth_fields[0] < 0 else cam.depth_fields[0]
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
