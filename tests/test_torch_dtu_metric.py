"""The port's DTU metric against the JAX package's, on the CPU.

  - reduce_points and nn_distances, both through the port's own build of
    eval/native/dtu_eval.cpp, equal the JAX package's native ones exactly
    for the same seed;
  - the plain (scipy cKDTree) versions equal the JAX package's scipy path
    exactly, and nn_distances_plain equals the native distances within
    1e-5 mm below the exact-search radius;
  - evaluate_scan, its error-cloud OBJs, evaluate_dtu and the CLI on a
    synthetic SampleSet tree give the JAX package's numbers and bytes
    (|dOverall| = 0 stated in the asserts);
  - the library lands under build/mvster_tpu_torch/dtu_eval/, and a missing
    or failing g++ raises (no fallback).
"""

import json
import os

import numpy as np
import pytest

from _torch_parity import plane_gt_points, write_dtu_gt_tree
from mvster_tpu_torch.eval import dtu_metric
from mvster_tpu_torch.infer.ply import write_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_metric():
    from mvster_tpu.eval import dtu_metric as jax_dtu

    assert jax_dtu._load_native() is not None, "the JAX package's native metric did not build"
    return jax_dtu


def cloud(seed, n=6000, extent=20.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, extent, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("dst,seed", [(0.2, 0), (0.7, 3)])
def test_reduce_points_equals_the_jax_native(jax_metric, dst, seed):
    pts = cloud(seed)
    got = dtu_metric.reduce_points(pts, dst, seed)
    np.testing.assert_array_equal(got, jax_metric.reduce_points(pts, dst, seed))
    assert 0 < len(got) <= len(pts)


def test_nn_distances_equals_the_jax_native(jax_metric):
    query, target = cloud(1, 3000, 30.0), cloud(2, 2000)
    for max_dist, radius in ((60.0, 25.0), (5.0, None), (60.0, 0.5)):
        np.testing.assert_array_equal(
            dtu_metric.nn_distances(query, target, max_dist, radius),
            jax_metric.nn_distances(query, target, max_dist, radius))
    assert (dtu_metric.nn_distances(query, target[:0]) == 60.0).all()


def test_plain_versions_equal_scipy(jax_metric, monkeypatch):
    pts, query = cloud(4, 3000), cloud(5, 1000, 40.0)
    plain = dtu_metric.reduce_points_plain(pts, 0.5, 7)
    near = dtu_metric.nn_distances_plain(query, pts, 60.0)
    # the JAX package's scipy path, the one it takes when its library is missing
    monkeypatch.setattr(jax_metric, "_load_native", lambda build=True: None)
    np.testing.assert_array_equal(plain, jax_metric.reduce_points(pts, 0.5, 7))
    np.testing.assert_array_equal(near, jax_metric.nn_distances(query, pts, 60.0))
    # the native library: other survivors with the same minimum spacing, the
    # same distances below its exact-search radius
    from scipy.spatial import cKDTree

    for red in (plain, dtu_metric.reduce_points(pts, 0.5, 7)):
        d, _ = cKDTree(red).query(red, k=2)
        assert d[:, 1].min() >= 0.5 - 1e-5
    native = dtu_metric.nn_distances(query, pts, 60.0, 25.0)
    exact = near < 25.0
    np.testing.assert_allclose(native[exact], near[exact], rtol=0, atol=1e-5)


def plane_case(seed=0):
    """A noisy, partial fused cloud of a 48 x 36 mm plane at z = 600 and
    its ground truth on a 0.5 mm grid."""
    k = np.array([[1000.0, 0, 40], [0, 1000.0, 30], [0, 0, 1]])
    stl = plane_gt_points(k, [np.eye(4)], 60, 80, 600.0, 0.5)
    rng = np.random.default_rng(seed)
    fused = stl[rng.uniform(size=len(stl)) < 0.6] + rng.normal(0, 0.3, (1, 3)).astype(np.float32)
    fused = fused + rng.normal(0, 0.2, fused.shape).astype(np.float32)
    return fused[fused[:, 0] > stl[:, 0].min() + 5], stl


def test_evaluate_scan_equals_jax(jax_metric, tmp_path):
    fused, stl = plane_case()
    mask = np.ones((60, 50, 20), np.uint8)
    mask[:25] = 0  # part of the fused cloud outside the observed voxels
    bb = np.array([stl.min(0) - 5, stl.max(0) + 5], np.float64)
    plane = np.array([0, 1.0, -1, 600.0])  # half of the ground truth below it
    kw = dict(dst=0.2, seed=3, scan_id=4)
    got = dtu_metric.evaluate_scan(fused, stl, mask, bb, 1.0, plane,
                                   error_obj_dir=str(tmp_path / "port"), **kw)
    want = jax_metric.evaluate_scan(fused, stl, mask, bb, 1.0, plane,
                                    error_obj_dir=str(tmp_path / "jax"), **kw)
    assert got == want
    overall = (got["acc_mean"] + got["comp_mean"]) / 2
    assert abs(overall - (want["acc_mean"] + want["comp_mean"]) / 2) == 0.0  # |dOverall|
    assert 0.1 < got["acc_mean"] < 1.0 and got["n_data"] < len(fused)
    for name in ("mvsnet2Stl_4.obj", "Stl2mvsnet_4.obj"):
        assert (open(tmp_path / "port" / name, "rb").read()
                == open(tmp_path / "jax" / name, "rb").read())


@pytest.fixture(scope="module")
def gt_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu_gt")
    for scan in (1, 9):
        fused, stl = plane_case(scan)
        write_dtu_gt_tree(str(root / "gt"), scan, stl)
        os.makedirs(root / "ply", exist_ok=True)
        write_ply(str(root / "ply" / f"mvsnet{scan:03d}_l3.ply"), fused)
    return str(root / "ply"), str(root / "gt")


def test_evaluate_dtu_equals_jax(jax_metric, gt_tree):
    ply_dir, gt_dir = gt_tree
    obs, bb, res = dtu_metric.load_obs_mask(f"{gt_dir}/ObsMask/ObsMask1_10.mat")
    assert obs.ndim == 3 and obs.all() and bb.shape == (2, 3) and res == 4.0
    got = dtu_metric.evaluate_dtu(ply_dir, gt_dir, [1, 9])
    want = jax_metric.evaluate_dtu(ply_dir, gt_dir, [1, 9])
    assert got == want
    assert abs(got["overall"] - want["overall"]) == 0.0  # |dOverall|
    assert got["overall"] == (got["accuracy"] + got["completeness"]) / 2
    assert [s["scan"] for s in got["per_scan"]] == [1, 9]


def test_cli_prints_the_summary(gt_tree, capsys):
    ply_dir, gt_dir = gt_tree
    dtu_metric.main([ply_dir, gt_dir, "9"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(dtu_metric.evaluate_dtu(ply_dir, gt_dir, [9])))


def test_native_library_lands_under_build():
    path = dtu_metric.build_native()
    assert path.exists()
    rel = os.path.relpath(path, REPO).split(os.sep)
    assert rel[:3] == ["build", "mvster_tpu_torch", "dtu_eval"] and rel[-1] == "libdtu_eval.so"
    assert not os.path.exists(os.path.join(REPO, "mvster_tpu_torch", "eval", "native",
                                           "libdtu_eval.so"))


@pytest.fixture
def unbuilt(monkeypatch, tmp_path):
    """An empty build root and no loaded library."""
    monkeypatch.setattr(dtu_metric, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(dtu_metric, "_lib", None)
    return tmp_path


def test_missing_compiler_raises(unbuilt, monkeypatch):
    monkeypatch.setattr(dtu_metric.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        dtu_metric.reduce_points(cloud(0, 10), 0.2)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        dtu_metric.nn_distances(cloud(0, 10), cloud(1, 10))
    assert not list((unbuilt / "build").rglob("*.so"))


def test_failing_compiler_raises(unbuilt, monkeypatch):
    bad = unbuilt / "dtu_eval.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(dtu_metric, "NATIVE_SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        dtu_metric.reduce_points(cloud(0, 10), 0.2)
    assert not list((unbuilt / "build").rglob("*.so"))
