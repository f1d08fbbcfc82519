"""PFM (portable float map) read/write (the port's copy of mvster_tpu.data.pfm).

The MVSNet family's wire format: a PF/Pf header, a scale line whose sign
encodes endianness, rows stored bottom-up.  numpy only.
"""

from __future__ import annotations

import sys

import numpy as np


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """Returns (data, abs_scale); data is (H, W) or (H, W, 3) float32, top-down."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline().split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        little_endian = scale < 0

        count = width * height * channels
        data = np.fromfile(f, dtype="<f4" if little_endian else ">f4", count=count)

    if data.size != count:
        raise ValueError(f"{path}: truncated PFM payload")
    shape = (height, width, 3) if channels == 3 else (height, width)
    # PFM stores rows bottom-up
    return np.flipud(data.reshape(shape)).astype(np.float32), abs(scale)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError("PFM payload must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = b"Pf"
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError(f"bad PFM shape {image.shape}")

    little_endian = image.dtype.byteorder == "<" or (
        image.dtype.byteorder == "=" and sys.byteorder == "little"
    )
    signed_scale = -scale if little_endian else scale

    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{signed_scale:f}\n".encode())
        np.flipud(image).tofile(f)
