"""DTU point-cloud benchmark in Python (the port's copy of mvster_tpu.eval.dtu_metric).

Mirrors the reference evaluation chain
(evaluations/dtu/BaseEvalMain_web.m -> PointCompareMain.m -> MaxDistCP.m ->
ComputeStat_web.m):

  1. reduce the fused cloud to 0.2 mm min-spacing (stochastic greedy thinning)
  2. accuracy  = distances fused -> GT STL, keep points inside the ObsMask
     voxel grid, drop >20 mm outliers, take the mean
  3. completeness = distances GT STL -> fused, keep STL points above the
     ground plane, drop >20 mm outliers, take the mean
  4. overall = (acc + comp) / 2

The thinning and the NN distances run in the C++ grid-hash library
(eval/native/dtu_eval.cpp, the JAX package's source and C ABI), built at
first use with g++ into build/mvster_tpu_torch/dtu_eval/<hash>/ at the
repository root.  If it cannot be built, reduce_points and nn_distances
raise: the metric never falls back quietly.  reduce_points_plain and
nn_distances_plain are the scipy cKDTree formulations the library is held
against in the tests.
"""

from __future__ import annotations

import ctypes
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

from mvster_tpu_torch.kernels import _build

NATIVE_SRC = Path(__file__).resolve().parent / "native" / "dtu_eval.cpp"
BUILD_ROOT = _build.BUILD_ROOT / "dtu_eval"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library for this source and host lands.  -march=native
    code runs on the CPU it was built for, so the host's name keys it too."""
    return _build.hashed_path(BUILD_ROOT, [NATIVE_SRC], CXX_FLAGS, "libdtu_eval.so",
                              salt=f"{platform.machine()} {platform.node()}")


def build_native() -> Path:
    """Compile eval/native/dtu_eval.cpp unless its library exists; raises
    RuntimeError when g++ is missing or fails."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the DTU metric's native library "
                           f"({NATIVE_SRC.name}) needs a C++ compiler")

    def make(tmp):
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(NATIVE_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")

    _build.publish(lib_path, make)
    return lib_path


def _load_native() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.reduce_points.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.reduce_points.restype = None
        lib.nn_distances.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ]
        lib.nn_distances.restype = None
        _lib = lib
    return _lib


def _cptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def reduce_points(pts: np.ndarray, dst: float = 0.2, seed: int = 0) -> np.ndarray:
    """Stochastic greedy thinning to min spacing dst; returns surviving points.

    pts: (N, 3).  Mirrors reducePts_haa.m (random visit order, each kept
    point suppresses all neighbors within dst).
    """
    pts = np.ascontiguousarray(pts, np.float32)
    n = len(pts)
    if n == 0:
        return pts
    keep = np.zeros(n, np.uint8)
    _load_native().reduce_points(
        _cptr(pts, ctypes.c_float), n, dst, seed, _cptr(keep, ctypes.c_uint8)
    )
    return pts[keep.astype(bool)]


def reduce_points_plain(pts: np.ndarray, dst: float = 0.2, seed: int = 0) -> np.ndarray:
    """reduce_points by scipy's cKDTree (another visit order than the
    library's, so other survivors with the same min spacing)."""
    from scipy.spatial import cKDTree

    pts = np.ascontiguousarray(pts, np.float32)
    n = len(pts)
    if n == 0:
        return pts
    tree = cKDTree(pts)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    active = np.ones(n, bool)
    for i in order:
        if not active[i]:
            continue
        neighbors = tree.query_ball_point(pts[i], dst)
        active[neighbors] = False
        active[i] = True
    return pts[active]


def nn_distances(query: np.ndarray, target: np.ndarray,
                 max_dist: float = 60.0,
                 accurate_radius: float | None = None) -> np.ndarray:
    """Per-query nearest-neighbor distance into target, clamped at max_dist.

    accurate_radius bounds the exact search (distances beyond it may be
    reported as upper bounds / max_dist); the DTU stats cut everything above
    20 mm, so passing ~25 keeps metric-relevant distances exact while far
    queries stay O(1).
    """
    query = np.ascontiguousarray(query, np.float32)
    target = np.ascontiguousarray(target, np.float32)
    if len(target) == 0:
        return np.full(len(query), max_dist, np.float32)
    out = np.zeros(len(query), np.float32)
    _load_native().nn_distances(
        _cptr(query, ctypes.c_float), len(query),
        _cptr(target, ctypes.c_float), len(target),
        max_dist, accurate_radius if accurate_radius else max_dist,
        _cptr(out, ctypes.c_float),
    )
    return out


def nn_distances_plain(query: np.ndarray, target: np.ndarray,
                       max_dist: float = 60.0) -> np.ndarray:
    """nn_distances by scipy's cKDTree, exact up to max_dist."""
    from scipy.spatial import cKDTree

    query = np.ascontiguousarray(query, np.float32)
    target = np.ascontiguousarray(target, np.float32)
    if len(target) == 0:
        return np.full(len(query), max_dist, np.float32)
    dist, _ = cKDTree(target).query(query, distance_upper_bound=max_dist)
    return np.minimum(np.nan_to_num(dist, posinf=max_dist), max_dist).astype(
        np.float32
    )


def load_obs_mask(mat_path: str):
    """ObsMask<set>_10.mat -> (mask bool array, BB (2,3), Res scalar)."""
    from scipy.io import loadmat

    m = loadmat(mat_path)
    return np.asarray(m["ObsMask"]), np.asarray(m["BB"], np.float64), float(
        np.asarray(m["Res"]).squeeze()
    )


def load_ground_plane(mat_path: str) -> np.ndarray:
    from scipy.io import loadmat

    return np.asarray(loadmat(mat_path)["P"], np.float64).reshape(4)


def points_in_obs_mask(pts: np.ndarray, obs_mask: np.ndarray, bb: np.ndarray,
                       res: float) -> np.ndarray:
    """Voxel-mask membership test (PointCompareMain.m:32-41).

    MATLAB: Qv = round((pts - BB(1,:)) / Res + 1), 1-based inclusive bounds.
    MATLAB round() is half-away-from-zero, numpy's is half-to-even; use
    floor(x + 0.5) (values here are positive) to match voxel assignment on
    exact .5 boundaries.
    """
    qv = np.floor((pts - bb[0]) / res + 1.5).astype(np.int64)  # 1-based
    inside = (
        (qv[:, 0] > 0) & (qv[:, 0] <= obs_mask.shape[0])
        & (qv[:, 1] > 0) & (qv[:, 1] <= obs_mask.shape[1])
        & (qv[:, 2] > 0) & (qv[:, 2] <= obs_mask.shape[2])
    )
    result = np.zeros(len(pts), bool)
    idx = qv[inside] - 1
    result[inside] = obs_mask[idx[:, 0], idx[:, 1], idx[:, 2]] != 0
    return result


def _error_colors(dists: np.ndarray, included: np.ndarray,
                  thresh: float = 10.0) -> np.ndarray:
    """BaseEval2Obj_web.m color ramp: included points shade white->red with
    distance 0->thresh mm; excluded points shade blue->green."""
    alpha = np.minimum(dists, thresh)[:, None] / thresh
    red_white = np.array([1, 0, 0]) * alpha + np.array([1, 1, 1]) * (1 - alpha)
    green_blue = np.array([0, 1, 0]) * alpha + np.array([0, 0, 1]) * (1 - alpha)
    return np.where(included[:, None], red_white, green_blue).astype(np.float32)


def _write_obj_cloud(path: str, pts: np.ndarray, colors: np.ndarray) -> None:
    """'v x y z r g b' per point — the BaseEval2Obj_web.m OBJ format."""
    with open(path, "w") as f:
        for (x, y, z), (r, g, b) in zip(pts, colors):
            f.write(f"v {x:f} {y:f} {z:f} {r:f} {g:f} {b:f}\n")


def write_error_clouds(out_dir: str, scan: int, data: np.ndarray,
                       d_data: np.ndarray, in_mask: np.ndarray,
                       stl: np.ndarray, d_stl: np.ndarray,
                       above: np.ndarray, method: str = "mvsnet") -> None:
    """Colored error-cloud visualization (BaseEval2Obj_web.m:1-43).

    Writes {method}2Stl_{scan}.obj (fused points colored by accuracy
    distance) and Stl2{method}_{scan}.obj (GT points colored by completeness
    distance); points excluded from the stats (outside ObsMask / below the
    ground plane) use the blue->green ramp.
    """
    os.makedirs(out_dir, exist_ok=True)
    _write_obj_cloud(
        os.path.join(out_dir, f"{method}2Stl_{scan}.obj"),
        data, _error_colors(d_data, in_mask),
    )
    _write_obj_cloud(
        os.path.join(out_dir, f"Stl2{method}_{scan}.obj"),
        stl, _error_colors(d_stl, above),
    )


def evaluate_scan(
    fused_pts: np.ndarray,
    stl_pts: np.ndarray,
    obs_mask: np.ndarray,
    bb: np.ndarray,
    res: float,
    ground_plane: np.ndarray,
    dst: float = 0.2,
    max_dist: float = 60.0,
    outlier_dist: float = 20.0,
    seed: int = 0,
    error_obj_dir: str | None = None,
    scan_id: int = 0,
    method: str = "mvsnet",
) -> dict:
    """Full single-scan evaluation; returns acc/comp stats.

    fused_pts: (N, 3) fused cloud; stl_pts: (M, 3) GT reference scan (already
    0.2 mm-reduced in the official release).
    """
    data = reduce_points(fused_pts, dst, seed)
    radius = outlier_dist * 1.25  # only sub-cutoff distances affect the stats
    d_data = nn_distances(data, stl_pts, max_dist, radius)  # accuracy
    d_stl = nn_distances(stl_pts, data, max_dist, radius)  # completeness

    in_mask = points_in_obs_mask(data, obs_mask, bb, res)
    above = (
        ground_plane[0] * stl_pts[:, 0]
        + ground_plane[1] * stl_pts[:, 1]
        + ground_plane[2] * stl_pts[:, 2]
        + ground_plane[3]
    ) > 0

    if error_obj_dir:
        write_error_clouds(
            error_obj_dir, scan_id, data, d_data, in_mask, stl_pts, d_stl,
            above, method=method,
        )

    facc = d_data[in_mask]
    facc = facc[facc < outlier_dist]
    fcomp = d_stl[above]
    fcomp = fcomp[fcomp < outlier_dist]

    return {
        "acc_mean": float(np.mean(facc)) if len(facc) else float("nan"),
        "acc_median": float(np.median(facc)) if len(facc) else float("nan"),
        "comp_mean": float(np.mean(fcomp)) if len(fcomp) else float("nan"),
        "comp_median": float(np.median(fcomp)) if len(fcomp) else float("nan"),
        "n_data": int(len(data)),
        "n_stl": int(len(stl_pts)),
    }


def aggregate_stats(per_scan: list[dict]) -> dict:
    """ComputeStat_web.m aggregation: mean over scans, overall = (acc+comp)/2."""
    acc = float(np.mean([s["acc_mean"] for s in per_scan]))
    comp = float(np.mean([s["comp_mean"] for s in per_scan]))
    return {"accuracy": acc, "completeness": comp, "overall": (acc + comp) / 2}


def evaluate_dtu(
    ply_dir: str,
    gt_dir: str,
    scan_ids: list[int],
    method: str = "mvsnet",
    light: str = "l3",
    **kwargs,
) -> dict:
    """Evaluate fused PLYs against the DTU SampleSet layout.

    ply_dir: directory holding {method}{scan:03d}_{light}.ply files.
    gt_dir: SampleSet/MVS Data directory (Points/stl + ObsMask).
    """
    from mvster_tpu_torch.infer.ply import read_ply

    per_scan = []
    for scan in scan_ids:
        fused, _ = read_ply(
            os.path.join(ply_dir, f"{method}{scan:03d}_{light}.ply")
        )
        stl, _ = read_ply(
            os.path.join(gt_dir, "Points/stl", f"stl{scan:03d}_total.ply")
        )
        obs_mask, bb, res = load_obs_mask(
            os.path.join(gt_dir, "ObsMask", f"ObsMask{scan}_10.mat")
        )
        plane = load_ground_plane(
            os.path.join(gt_dir, "ObsMask", f"Plane{scan}.mat")
        )
        stats = evaluate_scan(
            fused, stl, obs_mask, bb, res, plane, scan_id=scan,
            method=method, **kwargs,
        )
        stats["scan"] = scan
        per_scan.append(stats)
    summary = aggregate_stats(per_scan)
    summary["per_scan"] = per_scan
    return summary


def main(argv=None):
    """CLI: score fused PLYs against the DTU ground truth.

    python -m mvster_tpu_torch.eval.dtu_metric <ply_dir> <gt_dir> 1 4 9 ...
    (gt_dir = the SampleSet "MVS Data" directory; scan ids default to the
    22-scan DTU evaluation set, BaseEvalMain_web.m:28)
    """
    import argparse
    import json

    default_scans = [1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48,
                     49, 62, 75, 77, 110, 114, 118]
    ap = argparse.ArgumentParser(description="DTU point-cloud benchmark")
    ap.add_argument("ply_dir")
    ap.add_argument("gt_dir")
    ap.add_argument("scans", nargs="*", type=int, default=None)
    ap.add_argument("--method", default="mvsnet")
    ap.add_argument("--light", default="l3")
    ap.add_argument("--error_obj_dir", default=None,
                    help="also write BaseEval2Obj-style colored error-cloud "
                         ".obj files per scan into this directory")
    args = ap.parse_args(argv)

    summary = evaluate_dtu(
        args.ply_dir, args.gt_dir, args.scans or default_scans,
        method=args.method, light=args.light,
        error_obj_dir=args.error_obj_dir,
    )
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
