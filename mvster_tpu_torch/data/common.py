"""Shared dataset plumbing (the port's copy of mvster_tpu.data.common).

Cam/pair parsing, image IO, augmentation and per-stage pyramids for the
loaders; all outputs are channels-last numpy.  PIL and cv2 are imported
inside the functions that use them, so the rest of the port runs without
them.
"""

from __future__ import annotations

import dataclasses
import random as pyrandom

import numpy as np


@dataclasses.dataclass
class CamFile:
    intrinsics: np.ndarray  # (3, 3)
    extrinsics: np.ndarray  # (4, 4)
    depth_fields: list[float]  # the trailing depth-range line, as floats


def read_cam_file(path: str) -> CamFile:
    """Parse the MVSNet-style cam.txt: extrinsic 4x4, intrinsic 3x3, depth line."""
    with open(path) as f:
        lines = [ln.rstrip() for ln in f.readlines()]
    extr = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intr = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    fields = [float(x) for x in lines[11].split()] if len(lines) > 11 and lines[11] else []
    return CamFile(intr, extr, fields)


def write_cam_file(path: str, extrinsics: np.ndarray, intrinsics4: np.ndarray) -> None:
    """Write extrinsic 4x4 + intrinsic block (rows 0-2 = K, row 3 = depth line)."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in extrinsics:
            f.write(" ".join(str(v) for v in row) + " \n")
        f.write("\nintrinsic\n")
        for row in intrinsics4[:3, :3]:
            f.write(" ".join(str(v) for v in row) + " \n")
        f.write(
            "\n"
            + " ".join(str(v) for v in intrinsics4[3][:4])
            + "\n"
        )


def read_pair_file(path: str) -> list[tuple[int, list[int]]]:
    """pair.txt -> [(ref_view, [src views ranked by score])]."""
    pairs = []
    with open(path) as f:
        num = int(f.readline())
        for _ in range(num):
            ref = int(f.readline().rstrip())
            fields = f.readline().rstrip().split()
            srcs = [int(x) for x in fields[1::2]]
            if srcs:
                pairs.append((ref, srcs))
    return pairs


def sample_rng(seed, epoch: int, idx: int) -> pyrandom.Random:
    """Per-sample augmentation RNG, deterministic in (seed, epoch, idx).

    Deriving the RNG inside __getitem__ (rather than advancing a dataset-held
    Random) makes augmentation draws identical whether samples are decoded
    in-process or in loader pool workers, and distinct across epochs even
    though the pickled dataset state never flows back from workers.
    """
    base = 0 if seed is None else int(seed)
    return pyrandom.Random((base * 1_000_003 + int(epoch)) * 1_000_003 + int(idx))


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.float32) / 255.0


def color_jitter(path_or_img, rng: pyrandom.Random, brightness=0.5, contrast=0.5):
    """Brightness/contrast jitter with torchvision ColorJitter semantics.

    Factors are drawn uniformly from [max(0, 1-x), 1+x] and the two ops are
    applied in random order (the reference trains with
    ColorJitter(brightness=0.5, contrast=0.5), dtu_yao4.py:21).
    """
    from PIL import Image, ImageEnhance

    img = Image.open(path_or_img) if isinstance(path_or_img, str) else path_or_img
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    ops = [
        lambda im: ImageEnhance.Brightness(im).enhance(b),
        lambda im: ImageEnhance.Contrast(im).enhance(c),
    ]
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return np.asarray(img, dtype=np.float32) / 255.0


def nearest_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.INTER_NEAREST-compatible resize (index map floor(i*in/out))."""
    h, w = img.shape[:2]
    # cv2 nearest picks source index floor((i + 0.5) * in/out) clipped
    rows = np.minimum((np.arange(out_h) * h / out_h + 1e-9).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(out_w) * w / out_w + 1e-9).astype(np.int64), w - 1)
    return img[rows][:, cols]


def stage_pyramid(img: np.ndarray, interp=nearest_resize) -> dict[str, np.ndarray]:
    """{stage1..4} pyramid at 1/8, 1/4, 1/2, 1 of the input resolution."""
    h, w = img.shape[:2]
    return {
        "stage1": interp(img, h // 8, w // 8),
        "stage2": interp(img, h // 4, w // 4),
        "stage3": interp(img, h // 2, w // 2),
        "stage4": img,
    }


def stage_projections(proj: np.ndarray, base_stage: int) -> dict[str, np.ndarray]:
    """Per-stage intrinsic scaling from a (V, 2, 4, 4) stack.

    base_stage is the stage the input intrinsics correspond to (2 for DTU
    loaders whose cam files are quarter-res, 4 for full-res loaders); other
    stages scale the first two intrinsic rows by powers of two.
    """
    out = {}
    for s in range(1, 5):
        p = proj.copy()
        p[..., 1, :2, :] *= 2.0 ** (s - base_stage)
        out[f"stage{s}"] = p.astype(np.float32)
    return out


def center_crop(img: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    y0 = (h - target_h) // 2
    x0 = (w - target_w) // 2
    return img[y0 : y0 + target_h, x0 : x0 + target_w]


def snap_resize(img: np.ndarray, intrinsics: np.ndarray, max_h: int, max_w: int,
                base: int = 64):
    """Resize to fit within (max_h, max_w), snapped down to multiples of `base`.

    Rescales the intrinsics accordingly; the general-eval resolution policy
    (general_eval4.py:92-109).
    """
    import cv2

    h, w = img.shape[:2]
    if h > max_h or w > max_w:
        scale = max_h / h
        if scale * w > max_w:
            scale = max_w / w
        new_w, new_h = scale * w // base * base, scale * h // base * base
    else:
        new_w, new_h = 1.0 * w // base * base, 1.0 * h // base * base
    new_w, new_h = int(new_w), int(new_h)
    intrinsics = intrinsics.copy()
    intrinsics[0, :] *= new_w / w
    intrinsics[1, :] *= new_h / h
    return cv2.resize(img, (new_w, new_h)), intrinsics
