"""The port's inference and fusion tool against the JAX inference tool, on the CPU.

Both inference tools run the general_eval path over the synthetic scan of
scripts/smoke_test_cli.write_scan (textured plane, 128x128, 3 views) with
the same random weights: the JAX inference tool's save_depth and fuse_scan
from flax variables, the port's tools.test.main (forward, fusion and the
DTU metric against a synthetic ground truth of the plane) from the same
weights saved as a reference-style checkpoint.  Their depth and confidence
PFMs, cams and images must agree; the port's fuse_scan over the JAX tool's
depth maps must give the JAX tool's masks and PLY; the port's
dtu_metrics.json must be the JAX metric of the port's PLY.  Then the port
alone: --fix_res pins a second scan to the first one's size, --filter_method
gipuma raises, and Tanks and ETH3D trees go through main to one PLY a scan.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from _torch_parity import (
    jax_variables,
    plane_gt_points,
    write_dtu_gt_tree,
    write_eth3d_tree,
    write_plane_scan,
    write_tanks_tree,
)
from helpers import synthetic_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_ARGS = ["--group_cor", "--inverse_depth", "--attn_temp", "2"]
SCAN_ARGS = ["--dataset", "general_eval", "--num_view", "3", "--max_h", "128",
             "--max_w", "128", *MODEL_ARGS]
FUSION_ARGS = ["--conf", "0.3", "--thres_view", "1"]  # 2 sources a view


def _write_scan(root):
    spec = importlib.util.spec_from_file_location(
        "smoke_test_cli", os.path.join(REPO, "scripts", "smoke_test_cli.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_scan(str(root))


@pytest.fixture(scope="module")
def random_ckpt(tmp_path_factory):
    """Random dtu_default(mono=False) flax variables and the same weights as
    a reference-style checkpoint."""
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    config = JaxConfig.dtu_default(mono=False)
    variables = jax_variables(config, synthetic_sample(0, nviews=3, h=128, w=128), 0)
    ckpt = tmp_path_factory.mktemp("ckpt") / "model.ckpt"
    torch.save({"model": state_dict_from_jax(variables)}, ckpt)
    return config, variables, str(ckpt)


@pytest.fixture(scope="module")
def both_outputs(tmp_path_factory, random_ckpt):
    from mvster_tpu.data.pfm import read_pfm
    from mvster_tpu.models import MVS4Net as JaxMVS4Net
    from mvster_tpu.tools import test as jax_test
    from mvster_tpu_torch.tools import test as port_test

    config, variables, ckpt = random_ckpt
    root = tmp_path_factory.mktemp("scan")
    scan = _write_scan(root)
    # the plane's ground truth: write_scan's 128x128 cameras, 300 apart, at 600
    k = np.array([[140.8, 0, 64], [0, 140.8, 64], [0, 0, 1]])
    extrs = [np.eye(4) for _ in range(3)]
    extrs[1][0, 3], extrs[2][0, 3] = 300.0, -300.0
    gt_dir = str(root / "gt")
    write_dtu_gt_tree(gt_dir, 1, plane_gt_points(k, extrs, 128, 128, 600.0, 4.0))

    outs = {}
    for name in ("jax", "port"):
        outdir = str(root / name)
        argv = ["--testpath", str(root), "--testlist", scan, "--loadckpt",
                ckpt, "--outdir", outdir, *SCAN_ARGS, *FUSION_ARGS]
        if name == "jax":
            args = jax_test.build_test_parser().parse_args(argv)
            jax_test.save_depth(args, JaxMVS4Net(config), variables, [scan])
            # a copy of the JAX tool's depth maps for the port's fusion
            shutil.copytree(os.path.join(outdir, scan), str(root / "jax_maps" / scan))
            jax_test.fuse_scan(args, scan)
            outs["args"] = args
        else:
            outs["times"] = port_test.main(argv + ["--device", "cpu", "--dtu_gt_dir", gt_dir])
        outs[name] = {
            kind: [read_pfm(os.path.join(outdir, scan, kind, f"{v:08d}.pfm"))[0]
                   for v in range(3)]
            for kind in ("depth_est", "confidence")
        }
        outs[name]["dir"] = os.path.join(outdir, scan)
        outs[name]["outdir"] = outdir
    outs.update(scan=scan, gt_dir=gt_dir, jax_maps=str(root / "jax_maps"))
    return outs


def test_depth_maps_match_jax(both_outputs):
    jax_out, port_out = both_outputs["jax"], both_outputs["port"]
    for v in range(3):
        want, got = jax_out["depth_est"][v], port_out["depth_est"][v]
        assert got.shape == want.shape == (128, 128)
        assert np.isfinite(got).all() and got.min() > 0
        # argmax flips at near-ties move a pixel by a hypothesis bin; they
        # must stay rare (the model tests bound them stage by stage)
        same = np.isclose(got, want, rtol=1e-4)
        assert same.mean() >= 0.99, f"view {v}: {same.mean():.2%} of depths agree"
        np.testing.assert_allclose(port_out["confidence"][v][same],
                                   jax_out["confidence"][v][same], atol=2e-3)


def test_writes_the_jax_layout(both_outputs):
    jax_dir, port_dir = both_outputs["jax"]["dir"], both_outputs["port"]["dir"]
    for v in range(3):
        for rel in (f"cams/{v:08d}_cam.txt", f"images/{v:08d}.jpg"):
            with open(os.path.join(jax_dir, rel), "rb") as f:
                want = f.read()
            with open(os.path.join(port_dir, rel), "rb") as f:
                assert f.read() == want, rel


def test_infer_views_pads_the_last_chunk():
    """eval_batch 2 over 3 views (last chunk padded) gives eval_batch 1's maps."""
    from helpers import plane_scene_sample
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.test import infer_views
    from mvster_tpu_torch.tools.weights import random_state_dict

    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False)).eval()
    model.load_state_dict(random_state_dict(model, seed=0), strict=True)
    views = []
    for seed in range(3):
        s = plane_scene_sample(seed)
        views.append({"imgs": s["imgs"][0], "depth_values": s["depth_values"][0],
                      "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()}})
    one = list(infer_views(model, views, eval_batch=1))
    two = list(infer_views(model, views, eval_batch=2))
    assert [r["chunk_views"] for _, r in two] == [2, 2, 1]
    for (s1, r1), (s2, r2) in zip(one, two):
        assert s1 is s2
        assert r1["depth"].shape == r2["depth"].shape == (1, 64, 64)
        same = np.isclose(r1["depth"], r2["depth"], rtol=1e-4)
        assert same.mean() >= 0.99
        np.testing.assert_allclose(r1["confidence"][same], r2["confidence"][same],
                                   atol=1e-4)


def _read_mask(path):
    import cv2

    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


def test_port_fusion_of_the_jax_depth_maps_gives_the_jax_ply(both_outputs):
    from mvster_tpu.infer.ply import read_ply
    from mvster_tpu_torch.tools.test import fuse_scan

    scan, args = both_outputs["scan"], both_outputs["args"]
    args = type(args)(**{**vars(args), "outdir": both_outputs["jax_maps"]})
    ply_path = fuse_scan(args, scan, "cpu")
    assert os.path.basename(ply_path) == "mvsnet001_l3.ply"
    want_dir = both_outputs["jax"]["outdir"]
    got, got_rgb = read_ply(ply_path)
    want, want_rgb = read_ply(os.path.join(want_dir, "mvsnet001_l3.ply"))
    assert len(want) > 1000, "the JAX fusion kept too few points to compare"
    # the same masks (on the CPU no pixel lies at a threshold's edge here)
    for v in range(3):
        for kind in ("photo", "geo", "final"):
            rel = f"mask/{v:08d}_{kind}.png"
            np.testing.assert_array_equal(
                _read_mask(os.path.join(both_outputs["jax_maps"], scan, rel)),
                _read_mask(os.path.join(want_dir, scan, rel)), err_msg=rel)
    # so the same points in the same pixel order
    assert got.shape == want.shape
    gap = np.linalg.norm(got - want, axis=-1)
    assert (gap <= 1e-5 * np.linalg.norm(want, axis=-1)).all(), gap.max()
    np.testing.assert_array_equal(got_rgb, want_rgb)


def test_main_writes_the_ply_masks_and_dtu_metric(both_outputs):
    from mvster_tpu.eval.dtu_metric import evaluate_dtu
    from mvster_tpu_torch.infer.ply import read_ply

    outdir = both_outputs["port"]["outdir"]
    xyz, rgb = read_ply(os.path.join(outdir, "mvsnet001_l3.ply"))
    assert len(xyz) > 1000 and rgb.shape == xyz.shape and np.isfinite(xyz).all()
    for v in range(3):
        for kind in ("photo", "geo", "final"):
            m = _read_mask(os.path.join(outdir, "scan1", f"mask/{v:08d}_{kind}.png"))
            assert m.shape == (128, 128) and set(np.unique(m)) <= {0, 255}
    # a camera-frame cloud of view 0 (every --save_freq = 20 views)
    local, _ = read_ply(os.path.join(outdir, "scan1", "ply_local", "00000000.ply"))
    assert len(local) == 128 * 128
    with open(os.path.join(outdir, "dtu_metrics.json")) as f:
        got = json.load(f)
    want = evaluate_dtu(outdir, both_outputs["gt_dir"], [1])
    assert got == json.loads(json.dumps(want))
    assert abs(got["overall"] - want["overall"]) == 0.0  # |dOverall|
    assert np.isfinite([got["accuracy"], got["completeness"], got["overall"]]).all()
    times = both_outputs["times"]
    assert times["views"] == 3 and set(times["fusion"]) == {"scan1"} and times["metric"] > 0


def test_gipuma_filter_raises(tmp_path):
    from mvster_tpu_torch.tools.test import main

    with pytest.raises(NotImplementedError, match="gipuma"):
        main(["--testpath", str(tmp_path), "--testlist", "scan1", "--loadckpt",
              "missing.ckpt", "--filter_method", "gipuma", "--device", "cpu"])


def test_fix_res_pins_the_second_scan_to_the_first_size(tmp_path, random_ckpt):
    from mvster_tpu_torch.data.pfm import read_pfm
    from mvster_tpu_torch.tools.test import main

    write_plane_scan(str(tmp_path), "scan1", n_views=3, h=128, w=128)
    write_plane_scan(str(tmp_path), "scan2", n_views=3, h=192, w=128)
    (tmp_path / "list.txt").write_text("scan1\nscan2\n")
    shapes = {}
    for fix in (False, True):
        outdir = str(tmp_path / f"out_{fix}")
        main(["--testpath", str(tmp_path), "--testlist", str(tmp_path / "list.txt"),
              "--loadckpt", random_ckpt[2], "--outdir", outdir, "--num_view", "3",
              "--max_h", "256", "--max_w", "256", *MODEL_ARGS, *FUSION_ARGS,
              "--device", "cpu"] + (["--fix_res"] if fix else []))
        shapes[fix] = [read_pfm(os.path.join(outdir, s, "depth_est", "00000001.pfm"))[0].shape
                       for s in ("scan1", "scan2")]
        assert os.path.exists(os.path.join(outdir, "mvsnet002_l3.ply"))
    assert shapes[False] == [(128, 128), (192, 128)]
    assert shapes[True] == [(128, 128), (128, 128)]


@pytest.mark.parametrize("dataset", ["tanks", "eth3d"])
def test_main_fuses_every_scan_of_tanks_and_eth3d(tmp_path, random_ckpt, monkeypatch, dataset):
    """Tanks (1080 rows cut to 1024, here 120 to 64) and ETH3D (resized to
    1920x1280, here to 128x64) through main: one PLY and the masks a scan,
    and with --save_jpg each stage's depth as a jpg."""
    import functools

    from mvster_tpu_torch.data.eth3d import ETH3DDataset
    from mvster_tpu_torch.infer.ply import read_ply
    from mvster_tpu_torch.tools import test as port_test

    if dataset == "tanks":
        scans = write_tanks_tree(str(tmp_path), "intermediate", n_views=3, h=120, w=128)
        n_views = 3
    else:
        scans = write_eth3d_tree(str(tmp_path), n_views=2, h=72, w=144)
        n_views = 2
        monkeypatch.setattr(port_test, "find_dataset_def",
                            lambda name: functools.partial(ETH3DDataset, img_wh=(128, 64)))
    outdir = str(tmp_path / "out")
    times = port_test.main(
        ["--dataset", dataset, "--testpath", str(tmp_path), "--testlist", "all",
         "--loadckpt", random_ckpt[2], "--outdir", outdir, "--num_view", str(n_views),
         *MODEL_ARGS, *FUSION_ARGS, "--save_jpg", "--device", "cpu"])
    assert times["views"] == n_views * len(scans) and list(times["fusion"]) == scans
    for scan in scans:
        xyz, _ = read_ply(os.path.join(outdir, f"{scan}.ply"))
        assert np.isfinite(xyz).all()
        for rel in ["00000000.pfm"] + [f"00000000stage_{s}.jpg" for s in range(1, 5)]:
            assert os.path.exists(os.path.join(outdir, scan, "depth_est", rel)), rel
        for v in range(n_views):
            assert os.path.exists(os.path.join(outdir, scan, f"mask/{v:08d}_final.png"))
    assert not os.path.exists(os.path.join(outdir, "dtu_metrics.json"))


def _flag_argvs(parser):
    """Per option of `parser`: argv lists that set it to each of its choices
    (or to a value of its type), after the parser's required flags."""
    import argparse

    required = []
    for a in parser._actions:
        if a.required:
            required += [a.option_strings[0], "x"]
    for a in parser._actions:
        if not a.option_strings or isinstance(a, argparse._HelpAction):
            continue
        opt = a.option_strings[0]
        if a.nargs == 0:  # store_true
            yield a, [*required, opt]
        elif a.choices:
            for c in a.choices:
                yield a, [*required, opt, str(c)]
        else:
            yield a, [*required, opt, "x" if a.default is None else str(a.default)]


@pytest.mark.parametrize("name", ["build_test_parser", "build_train_parser"])
def test_every_jax_flag_and_choice_parses(name):
    """Each option string and each choice of the JAX parser parses in the
    port's, to the same value; the port adds --device alone."""
    from mvster_tpu.tools import cli as jax_cli
    from mvster_tpu_torch.tools import cli as port_cli

    jax_parser, port_parser = getattr(jax_cli, name)(), getattr(port_cli, name)()
    port_actions = {s: a for a in port_parser._actions for s in a.option_strings}
    jax_options = set()
    for action, argv in _flag_argvs(jax_parser):
        jax_options.update(action.option_strings)
        for opt in action.option_strings:
            assert opt in port_actions, opt
            assert port_actions[opt].dest == action.dest, opt
        want = getattr(jax_parser.parse_args(argv), action.dest)
        assert getattr(port_parser.parse_args(argv), action.dest) == want, argv
    assert set(port_actions) - jax_options == {"-h", "--help", "--device"}


@pytest.mark.parametrize("fold", ["auto", "on", "off"])
def test_reg2d_fold_reaches_the_config_as_in_jax(fold):
    """--reg2d_fold sets the config's reg2d_fold as the JAX CLI does (the
    port accepts it and runs the same function either way)."""
    from mvster_tpu.tools import cli as jax_cli
    from mvster_tpu_torch.tools import cli as port_cli

    argv = ["--testpath", "x", "--testlist", "x", "--loadckpt", "x", "--reg2d_fold", fold]
    want = jax_cli.model_config_from_args(jax_cli.build_test_parser().parse_args(argv))
    got = port_cli.model_config_from_args(port_cli.build_test_parser().parse_args(argv))
    assert got.reg2d_fold == want.reg2d_fold
