"""Binary PLY point-cloud IO (the port's copy of mvster_tpu.infer.ply).

Writes the same wire format the reference emits via plyfile
(test_mvs4.py:408-421): binary_little_endian 1.0, vertex x/y/z float32 +
red/green/blue uchar.  numpy only.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None) -> None:
    """xyz: (N, 3) float; rgb: optional (N, 3) uint8."""
    xyz = np.ascontiguousarray(xyz, dtype="<f4")
    n = xyz.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += ["property float x", "property float y", "property float z"]
    if rgb is not None:
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        dtype = np.dtype(
            [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
             ("red", "u1"), ("green", "u1"), ("blue", "u1")]
        )
        rec = np.empty(n, dtype)
        rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    else:
        dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        rec = np.empty(n, dtype)
        rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def camera_pointcloud(depth: np.ndarray, intrinsics: np.ndarray,
                      rgb: np.ndarray | None = None):
    """Unproject a depth map to a camera-frame colored point cloud.

    Vectorized replacement for the reference's per-pixel python loop
    (utils.py generate_pointcloud / test_mvs4.py:263-264 'ply_local' dumps):
    x = (u - cx) / fx * d, y = (v - cy) / fy * d, z = d; pixels with
    non-positive depth are dropped.  Returns (xyz (N,3), rgb (N,3) or None).
    """
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    valid = depth > 0
    d = depth[valid]
    xyz = np.stack(
        [(u[valid] - cx) / fx * d, (v[valid] - cy) / fy * d, d], axis=-1
    ).astype(np.float32)
    colors = None
    if rgb is not None:
        colors = rgb[valid]
    return xyz, colors


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Minimal reader for binary/ascii PLY vertex clouds -> (xyz, rgb|None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((parts[2], parts[1]))

        type_map = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "ushort": "u2", "int": "i4", "uint": "u4",
        }
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            names = [p[0] for p in props]
            xyz = data[:, [names.index(c) for c in "xyz"]].astype(np.float32)
            if {"red", "green", "blue"} <= set(names):
                rgb = data[
                    :, [names.index(c) for c in ("red", "green", "blue")]
                ].astype(np.uint8)
            else:
                rgb = None
            return xyz, rgb

        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(name, endian + type_map[t]) for name, t in props])
        rec = np.fromfile(f, dtype=dtype, count=n)
    xyz = np.stack(
        [rec["x"], rec["y"], rec["z"]], axis=1
    ).astype(np.float32)
    rgb = None
    if "red" in dtype.names:
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1).astype(np.uint8)
    return xyz, rgb
