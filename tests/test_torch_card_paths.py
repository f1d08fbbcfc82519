"""The port's entry points end to end on the card (marked `cuda`; each skips without one).

The kernel files hold each kernel against its plain version; this file
holds the paths that call them, at 128x192 with 3 views (a synthetic DTU
tree of 7 samples, textured planes): tools.train.main and tools.test.main
(with fusion, the DTU metric, bf16, the vis dumps, Tanks), the BlendedMVS
fine-tune, a forward and a train step against the CPU, infer_views'
dispatch-ahead, the sg_cuts cuts, torchrun over NCCL, DDP as two gloo
ranks on the one card (NCCL puts no two ranks on one device), and both
spatial steps as two gloo ranks, each with the kernels' launches counted.
Ranks are this file run as a script (`python tests/test_torch_card_paths.py
<mode> <dir> ...`), as tests/test_torch_dist.py's.  The file imports no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_card_paths.py`.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    BAND_VARIANTS,
    GRAD_NOISE,
    assert_stage_close,
    cuda_device,
    flax_moments,
    launches,
    plain_eval,
    plain_warp,
    plane_batch,
    plane_gt_points,
    relative_l2,
    reset_launches,
    spawn_ranks,
    t,
    to_numpy_tree,
    torch_batch,
    wait_ranks,
    write_blendedmvs_tree,
    write_dtu_gt_tree,
    write_dtu_tree,
    write_plane_scan,
    write_tanks_tree,
)
from helpers import synthetic_sample
from mvster_tpu_torch.dist.train_step import make_train_step
from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
from mvster_tpu_torch.tools.weights import init_state_dict, load_reference_ckpt, random_state_dict

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
H, W, VIEWS, BATCH = 128, 192, 3, 2
SAMPLES = 7  # a DTU tree of one scan and one reference view: its 7 lights
PER_STEP = 4 * (VIEWS - 1)  # K2/K3 launches a train step: 4 stages x 2 sources
K6_PER_STEP = 28  # Reg2d's 7 planar convs x 4 stages
LOSS_KW = dict(inverse_depth=True, ot_iter=10, mono=True)
TRAIN_FLAGS = ["--nviews", str(VIEWS), "--batch_size", str(BATCH), "--epochs", "1",
               "--group_cor", "--inverse_depth", "--mono", "--attn_temp", "2",
               "--summary_freq", "1"]
SERVE_FLAGS = ["--group_cor", "--inverse_depth", "--attn_temp", "2"]
# tools.train.main's cases: (flags, the config they give, OT backend)
TRAIN_CASES = {
    "dtu_default": ([], {}, "xla"),
    "reg3d_learned_asff": (["--reg_mode", "reg3d", "--pos_enc", "2", "--ASFF",
                            "--ot_backend", "pallas"],
                           dict(reg_net="reg3d", pos_enc=2, asff=True), "pallas"),
}
# depth and group counts: dtu_default's, and others (K1 and K4/K5 at D 16
# and G 16, 2)
COUNTS = {"dtu_default": {},
          "other_counts": dict(stage_splits=(16, 8, 4, 4), group_cor_dim=(16, 8, 4, 2))}
# the sg_cuts hook: the parameters wholly upstream of a cut under the
# published loss weights (l1ot_lw (0, 1): the mono decoder's L1 weighs 0),
# and the modules that still get a gradient
SG_UPSTREAM = {"none": (), "fpn": ("feature.",), "mono": ("mono_depth_decoder.",),
               "warp": (), "cost_volume": ("feature.", "mono_depth_decoder."),
               "logits": ("reg.",)}
SG_DOWNSTREAM = {"none": ("feature.", "reg."), "fpn": ("reg.",), "mono": ("feature.", "reg."),
                 "warp": ("feature.", "reg."), "cost_volume": ("reg.",), "logits": ()}
# the scalars that count pixels: a value within float32 rounding of a
# threshold lands on either side under another batch composition
PIXEL_FRACTIONS, PIXEL_ATOL = ("thres", "s0_range", "s1_range", "s2_range", "s3_range"), 1e-4
STAGE_KEYS = ("attn_weight", "hypo_depth", "depth", "photometric_confidence")
# the spatial runs: dtu_default and each variant whose image-row sharding
# takes more than row-local layers, at dtu_default's widths (ASFF's
# fpn_base_channel 8 is dtu_default's)
SPATIAL_CASES = {"dtu_default": {}, **BAND_VARIANTS}
# the train steps' image size: dtu_default's at the DTU-mid train cell's
# 512x640, where one pixel's moved window weighs under the gradient rule's
# 1e-4 floor (at 128x192 a stage-2 pixel moves Reg2d's gradients ~1e-3)
SPATIAL_TRAIN_SIZE = {name: (512, 640) if name == "dtu_default" else (H, W)
                      for name in SPATIAL_CASES}
F64_ATTN_ATOL = 1e-9  # a float64 band's attention from one process's
F64_GRAD_RTOL = 1e-7  # a float64 band step's gradients from one process's
# float32, the kernels on: a band's convs round otherwise than the whole
# image's, and a near-tied argmax then moves a later stage's hypothesis
# window at a pixel, which the stage comparator does not forgive.  So a
# float32 serve is held by what a moved window leaves alone: each stage's
# windows agree with one process's float32 forward at F32_AGREE of the
# pixels, and the depth at F32_AGREE of the pixels where one process's top
# two probabilities differ by more than 0.05 (the comparator's decisive
# pixels)
F32_AGREE = 0.99
# a float32 train step's scalars against one process's float32 step whose
# BatchNorm takes the ranks' arithmetic (flax_moments): rtol 1e-5, the
# scalars downstream of a later stage's window at WINDOW_RTOL (at
# VARIANT_WINDOW_RTOL for the variants, whose pools and heads spread a
# moved window wider), the pixel fractions at PIXEL_ATOL more
WINDOW_SCALARS = ("loss", "s1_c_loss", "s2_c_loss", "s3_c_loss", "abs_depth_error")
WINDOW_RTOL, VARIANT_WINDOW_RTOL = 1e-4, 1e-3
# its gradients, each measured by its relative L2 distance from a float64
# step of its own split (the bands' float64 step, one process's): for
# dtu_default each tensor's within F32_NOISE_RATIO times one process's
# distance and the two within 1.5x their summed distances (or 1e-4;
# _torch_parity.check_grads' rule; a tensor that is zero in exact
# arithmetic by its L2 distance, within F32_NOISE_RATIO times one
# process's or GRAD_NOISE), the median within F32_MEDIAN_RATIO times; for
# a variant, whose moved windows move whole tensors by more than
# rounding does, every tensor finite and the median within F32_NOISE_RATIO
# times
F32_NOISE_RATIO, F32_MEDIAN_RATIO = 10.0, 2.0


def _seeded(config, seed):
    """random_state_dict with BatchNorm running statistics perturbed from a
    numpy seed: a decisive depth softmax, as the stage comparator wants."""
    model = MVS4Net(config)
    sd = random_state_dict(model, seed)
    rng = np.random.default_rng(seed)
    for key in sd:
        if key.endswith("running_mean"):
            sd[key] = t(rng.normal(0.0, 0.2, sd[key].shape))
        elif key.endswith("running_var"):
            sd[key] = t(rng.uniform(0.5, 2.0, sd[key].shape))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _inputs(sample, device, dtype=torch.float32):
    return (t(sample["imgs"], device).to(dtype),
            {k: t(v, device).to(dtype) for k, v in sample["proj_matrices"].items()},
            t(sample["depth_values"], device).to(dtype))


def _request(seed):
    s = synthetic_sample(seed, nviews=VIEWS, h=H, w=W)
    return {"imgs": s["imgs"][0], "depth_values": s["depth_values"][0],
            "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()}}


def _half_map(self, hr):
    """DTUDataset._prepare_map for the synthetic tree, whose maps are twice
    the images: half of it, without the 512x640 crop."""
    from mvster_tpu_torch.data.common import nearest_resize

    return nearest_resize(hr, hr.shape[0] // 2, hr.shape[1] // 2)


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    env.pop("LOCAL_RANK", None)
    return env


# ------------------------------------------------------------- training entry

@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    write_dtu_tree(root, n_views=VIEWS, h=H, w=W, n_refs=1)
    return root


def _train_argv(root, logdir, flags=()):
    return ["--trainpath", root, "--trainlist", f"{root}/train.txt", "--testlist",
            f"{root}/train.txt", "--logdir", logdir, *TRAIN_FLAGS, *flags]


@pytest.fixture(scope="module")
def trained(cuda_device, dtu_tree, tmp_path_factory):
    """tools.train.main of a TRAIN_CASES case, once a case: (its result,
    its kernels' launches, its log directory)."""
    from mvster_tpu_torch.data.dtu import DTUDataset
    from mvster_tpu_torch.tools import train

    runs = {}

    def run(case):
        if case not in runs:
            logdir = str(tmp_path_factory.mktemp(f"log_{case}"))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(DTUDataset, "_prepare_map", _half_map)
                reset_launches()
                result = train.main(_train_argv(dtu_tree, logdir, TRAIN_CASES[case][0]))
                torch.cuda.synchronize()
            runs[case] = (result, launches(), logdir)
        return runs[case]

    return run


def _expected_train_launches(steps, val_batches, backend, k6_per_step):
    pallas = backend == "pallas"
    return dict(K1=4 * val_batches, K2=PER_STEP * steps, K3=PER_STEP * steps,
                K4=4 * (steps + val_batches) if pallas else 0, K5=4 * steps if pallas else 0,
                K6=k6_per_step * steps, K7=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_entry_on_the_card(trained, case):
    result, counts, logdir = trained(case)
    _, overrides, backend = TRAIN_CASES[case]
    steps, val_batches = SAMPLES // BATCH, -(-SAMPLES // BATCH)
    assert result["steps"] == steps and result["backend"] is None
    k6 = 0 if overrides.get("reg_net") == "reg3d" else K6_PER_STEP
    assert counts == _expected_train_launches(steps, val_batches, backend, k6)
    records = _records(logdir)
    losses = [r["loss"] for r in records if r["mode"] == "train"]
    assert len(losses) == steps and np.isfinite(losses).all()
    val = [r for r in records if r["mode"] == "fulltest"]
    assert len(val) == 1 and np.isfinite(val[0]["loss"])

    config = MVS4NetConfig.dtu_default(**overrides)
    got = load_reference_ckpt(result["checkpoint"], config)
    model = MVS4Net(config)
    model.load_state_dict(got, strict=True)
    init = init_state_dict(model, seed=1)  # tools.train's --seed default
    params = {name for name, _ in model.named_parameters()}
    moved = {k for k in params if not torch.equal(got[k], init[k])}
    # l1ot_lw (0, 1): the mono decoder's loss weight is 0, so Adam leaves it
    assert moved == {k for k in params if not k.startswith("mono_depth_decoder.")}


@pytest.mark.cuda
def test_blendedmvs_fine_tune_on_the_card(cuda_device, tmp_path, monkeypatch):
    from mvster_tpu_torch.data.blendedmvs import BlendedMVSDataset
    from mvster_tpu_torch.tools import train

    root = str(tmp_path / "blended")
    write_blendedmvs_tree(root, n_views=4, h=64, w=128)  # 4 samples of 3 views
    # the loader resizes the GT to 768x576; cut it to the 64x128 images
    init = BlendedMVSDataset.__init__
    monkeypatch.setattr(BlendedMVSDataset, "__init__",
                        lambda self, *a, **kw: init(self, *a, **dict(kw, img_wh=(128, 64))))
    config = MVS4NetConfig.dtu_default()
    start = init_state_dict(MVS4Net(config), seed=5)
    ckpt = str(tmp_path / "dtu.ckpt")
    torch.save({"model": start}, ckpt)
    logdir = str(tmp_path / "log")
    reset_launches()
    result = train.main(["--dataset", "blendedmvs", "--trainpath", root,
                         "--trainlist", f"{root}/train.txt", "--testlist", f"{root}/train.txt",
                         "--logdir", logdir, "--loadckpt", ckpt, "--ot_backend", "pallas",
                         "--rt", *TRAIN_FLAGS])
    torch.cuda.synchronize()
    assert result["steps"] == 2
    assert launches() == _expected_train_launches(2, 2, "pallas", K6_PER_STEP)
    records = _records(logdir)
    assert {r["mode"] for r in records} == {"train", "fulltest"}
    for r in records:
        for key in ("loss", "epe", "err1", "err3"):
            assert np.isfinite(r[key]), (r["mode"], key)
    tuned = load_reference_ckpt(result["checkpoint"], config)
    params = {name for name, _ in MVS4Net(config).named_parameters()}
    moved = {k for k in params if not torch.equal(tuned[k], start[k])}
    assert moved == {k for k in params if not k.startswith("mono_depth_decoder.")}


# ------------------------------------------------------------- serving entry

@pytest.fixture(scope="module")
def plane_scan(tmp_path_factory):
    """A 4-view DTU test scan of a textured plane at 600 mm (one source 40 mm
    aside the next) and its SampleSet ground truth."""
    root = str(tmp_path_factory.mktemp("scan"))
    scan, k, extrs = write_plane_scan(root, "scan1", n_views=4, h=H, w=W, baseline=40.0)
    gt_dir = os.path.join(root, "SampleSet", "MVS Data")
    write_dtu_gt_tree(gt_dir, 1, plane_gt_points(k, extrs, H, W, 600.0, 1.0, min_views=3))
    return root, scan, gt_dir


SCAN_VIEWS, SCAN_FLAGS = 4, ["--num_view", "3", "--thres_view", "2", "--conf", "0.3"]
SERVE_CASES = {"float32": [], "bfloat16": ["--compute_dtype", "bfloat16"],
               "vis": ["--vis_ETA", "--vis_mono"], "tanks": None}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_entry_on_the_card(trained, plane_scan, tmp_path, case):
    from mvster_tpu_torch.data.pfm import read_pfm
    from mvster_tpu_torch.infer.ply import read_ply
    from mvster_tpu_torch.tools import test as test_tool

    ckpt = trained("dtu_default")[0]["checkpoint"]
    outdir = str(tmp_path / "out")
    if case == "tanks":
        root = str(tmp_path / "tanks")
        scans = write_tanks_tree(root, "intermediate", n_views=3, h=120, w=128)
        argv = ["--dataset", "tanks", "--split", "intermediate", "--testpath", root,
                "--testlist", "all", "--num_view", "3", "--thres_view", "1"]
        views, sources = 3 * len(scans), 2
    else:
        root, scan, gt_dir = plane_scan
        scans = [scan]
        argv = ["--testpath", root, "--testlist", scan, "--dtu_gt_dir", gt_dir, *SCAN_FLAGS,
                *SERVE_CASES[case]]
        views, sources = SCAN_VIEWS, 2
    reset_launches()
    times = test_tool.main([*argv, "--loadckpt", ckpt, "--outdir", outdir, *SERVE_FLAGS])
    torch.cuda.synchronize()
    k2 = 4 * sources * views if case == "vis" else 0  # the vis_ETA volumes: K2
    assert launches() == dict(K1=4 * views, K2=k2, K3=0, K4=0, K5=0, K6=0, K7=0)
    assert times["views"] == views and list(times["fusion"]) == scans
    for scan in scans:
        ply = "mvsnet001_l3.ply" if case != "tanks" else f"{scan}.ply"
        xyz, _ = read_ply(os.path.join(outdir, ply))
        assert np.isfinite(xyz).all()
    if case == "tanks":
        return
    for v in range(views):
        for kind in ("depth_est", "confidence"):
            m = read_pfm(os.path.join(outdir, scan, kind, f"{v:08d}.pfm"))[0]
            assert m.shape == (H, W) and np.isfinite(m).all(), (kind, v)
        for kind in ("photo", "geo", "final"):
            assert os.path.exists(os.path.join(outdir, scan, "mask", f"{v:08d}_{kind}.png"))
    with open(os.path.join(outdir, "dtu_metrics.json")) as f:
        assert {"accuracy", "completeness", "overall"} <= json.load(f).keys()
    if case == "vis":
        dumps = _vis_dumps(outdir, scan)
        assert len(dumps) == 5 * views  # 4 stages' attention and the features a view
        for path, a in dumps.items():
            assert np.isfinite(a).all(), path
            if "vis_mono" in path:
                assert a.shape == (1, H, W, 8), path
            else:  # a softmax over depth a source view
                assert a.shape[:2] == (sources, 1), path
                np.testing.assert_allclose(a.sum(axis=2), 1.0, atol=1e-5, err_msg=path)


def _vis_dumps(outdir, scan):
    return {os.path.relpath(os.path.join(d, f), outdir): np.load(os.path.join(d, f))
            for kind in ("vis_ETA", "vis_mono")
            for d, _, fs in os.walk(os.path.join(outdir, scan, kind)) for f in fs}


@pytest.mark.cuda
def test_vis_dumps_on_the_card_match_the_cpu(cuda_device, plane_scan, tmp_path, monkeypatch):
    """save_depth with --vis_ETA --vis_mono on the card against --device
    cpu, seeded weights whose depth softmax is decisive: vis_mono at
    rtol/atol 1e-4, vis_ETA at atol 1e-3 where the two runs' hypotheses
    agree, which must be all of stage 1's pixels and 99% of each other
    stage's (a near-tied argmax moves a later stage's window)."""
    from mvster_tpu_torch.tools import test as test_tool

    root, scan, _ = plane_scan
    ckpt = str(tmp_path / "seeded.ckpt")
    config = MVS4NetConfig.dtu_default(mono=False)
    torch.save({"model": _seeded(config, 22).state_dict()}, ckpt)
    infer_views, hypos, dumps = test_tool.infer_views, {}, {}

    def capture(*a, **k):  # each view's stage hypotheses, as save_depth passes them on
        for sample, res in infer_views(*a, **k):
            hypos[device][sample["filename"]] = [res[f"stage{s}_hypo"] for s in range(1, 5)]
            yield sample, res

    monkeypatch.setattr(test_tool, "infer_views", capture)
    for device in ("cuda", "cpu"):
        outdir = str(tmp_path / device)
        args = test_tool.build_test_parser().parse_args(
            ["--testpath", root, "--testlist", scan, "--loadckpt", ckpt, "--outdir", outdir,
             *SERVE_FLAGS, *SCAN_FLAGS, "--vis_ETA", "--vis_mono", "--device", device])
        config = test_tool.model_config_from_args(args)
        model = MVS4Net(config)
        model.load_state_dict(load_reference_ckpt(ckpt, config), strict=True)
        hypos[device] = {}
        test_tool.save_depth(args, model.to(args.device).eval(), [scan])
        dumps[device] = _vis_dumps(outdir, scan)
    assert sorted(dumps["cuda"]) == sorted(dumps["cpu"]) and len(dumps["cpu"]) == 5 * SCAN_VIEWS
    for path, want in dumps["cpu"].items():
        got = dumps["cuda"][path]
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if "vis_mono" in path:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=path)
            continue
        view, s = os.path.basename(path)[:8], int(path[-10])  # ..._stage{s}_attn.npy
        name = next(f for f in hypos["cpu"] if os.path.basename(f).startswith(view))
        agree = np.all(np.isclose(hypos["cuda"][name][s - 1], hypos["cpu"][name][s - 1],
                                  rtol=1e-5), axis=1)  # (1, h, w)
        assert agree.mean() >= 0.99 and (s > 1 or agree.all()), (path, agree.mean())
        sel = np.broadcast_to(agree[None, :, None], got.shape)
        np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=1e-3, err_msg=path)


# ----------------------------------------------------- the card against the CPU

@pytest.mark.cuda
@pytest.mark.parametrize("counts", list(COUNTS))
def test_forward_on_the_card_matches_the_cpu(cuda_device, counts):
    """The eval forward with seeded weights: 4 K1 launches, each stage's
    planes, the first stage's depth inside [dmin, dmax] and the final one
    within one first-stage inverse-depth bin of it (each later stage
    centres its window on the previous depth), and the CPU's forward by the
    stage comparator."""
    config = MVS4NetConfig.dtu_default(mono=False, **COUNTS[counts])
    model = _seeded(config, 16)
    card = copy.deepcopy(model).to(cuda_device)
    sample = synthetic_sample(16, nviews=VIEWS, h=H, w=W)
    with torch.inference_mode():
        reset_launches()
        out = to_numpy_tree(card(*_inputs(sample, cuda_device)))
        assert launches()["K1"] == 4
        ref = to_numpy_tree(model(*_inputs(sample, "cpu")))
    planes = [out[f"stage{s}"]["attn_weight"].shape[1] for s in range(1, 5)]
    assert planes == list(config.stage_splits)
    dmin, dmax = sample["depth_values"][0, 0], sample["depth_values"][0, -1]
    d1, depth = out["stage1"]["depth"], out["depth"]
    assert dmin * (1 - 1e-6) <= d1.min() and d1.max() <= dmax * (1 + 1e-6)
    bin1 = (1 / dmin - 1 / dmax) / (config.stage_splits[0] - 1)
    assert 1 / (1 / dmin + bin1) <= depth.min() and depth.max() <= 1 / (1 / dmax - bin1)
    assert depth.shape == (1, H, W) and np.isfinite(depth).all()
    assert np.isfinite(out["photometric_confidence"]).all()
    assert_stage_close(ref, out)


def _train_step(config, sd, batch, device, backend, dtype=torch.float32):
    """One train step (SGD at lr 0) from the state dict sd: its scalars,
    stage outputs and gradients (float64, on the host)."""
    model = MVS4Net(config)
    model.load_state_dict(sd, strict=True)
    model.to(device=device, dtype=dtype)
    captured = {}
    model.register_forward_hook(lambda m, i, o: captured.update(out=o))
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                           loss_kwargs=dict(LOSS_KW, ot_backend=backend))
    b = torch_batch(batch, device)
    if dtype == torch.float64:
        b = {k: ({s: x.double() for s, x in v.items()} if isinstance(v, dict) else v.double())
             for k, v in b.items()}
    scalars, _ = step(b)
    return dict(loss=float(scalars["loss"]), out=to_numpy_tree(captured["out"]),
                grads={k: p.grad.double().cpu().numpy() for k, p in model.named_parameters()})


@pytest.fixture(scope="module")
def cpu_steps():
    """Per COUNTS entry: its weights, the batch, and the CPU's float32 and
    float64 steps (the plain versions; the float64 step the exact value
    each float32 step approximates)."""
    runs = {}

    def run(counts):
        if counts not in runs:
            config = MVS4NetConfig.dtu_default(**COUNTS[counts])
            sd = random_state_dict(MVS4Net(config), seed=9)
            batch = plane_batch(1, h=H, w=W)
            runs[counts] = (config, sd, batch,
                            _train_step(config, sd, batch, "cpu", "xla"),
                            _train_step(config, sd, batch, "cpu", "xla", torch.float64))
        return runs[counts]

    return run


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("counts", list(COUNTS))
def test_train_step_on_the_card_matches_the_cpu(cuda_device, cpu_steps, counts, backend):
    """The card's step (K2/K3, K4/K5 with pallas, K6) against the CPU's
    plain one: the loss at rtol 1e-4, the stage outputs by the comparator,
    and each gradient within its float32 noise: its distance from the
    CPU's float64 gradient within 30x the CPU float32 one's (or 1e-3), and
    the card's and the CPU's within 1.5x their summed distances (or 1e-3).
    Both backends held to the one CPU loss hold them to each other."""
    config, sd, batch, cpu, exact = cpu_steps(counts)
    reset_launches()
    card = _train_step(config, sd, batch, cuda_device, backend)
    ot = 4 if backend == "pallas" else 0
    assert {k: v for k, v in launches().items() if k != "K6"} == dict(
        K1=0, K2=PER_STEP, K3=PER_STEP, K4=ot, K5=ot, K7=0)
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-4)
    assert_stage_close(cpu["out"], card["out"])
    for key, g_cpu in cpu["grads"].items():
        g_card, g_exact = card["grads"][key], exact["grads"][key]
        if np.linalg.norm(g_exact) < 1e-6:  # zero in exact arithmetic
            np.testing.assert_allclose(g_card, g_cpu, atol=1e-6, err_msg=key)
            continue
        e_cpu, e_card = relative_l2(g_cpu, g_exact), relative_l2(g_card, g_exact)
        rel = relative_l2(g_card, g_cpu)
        assert e_card <= max(1e-3, 30 * e_cpu), (key, e_card, e_cpu)
        assert rel <= max(1e-3, 1.5 * (e_card + e_cpu)), (key, rel, e_card, e_cpu)


@pytest.mark.cuda
def test_infer_views_on_the_card_is_one_model_call_a_chunk(cuda_device):
    """infer_views launches chunk i+1 before it hands out chunk i's views,
    copied behind an event into pinned memory: with cuDNN's deterministic
    algorithms every view's depth and confidence are bitwise those of one
    model call a chunk in sequence (the last chunk padded as infer_views
    pads it), with 4 K1 launches a chunk."""
    from mvster_tpu_torch.tools.test import infer_views

    model = _seeded(MVS4NetConfig.dtu_default(mono=False), 17).to(cuda_device)
    requests = [_request(170 + i) for i in range(5)]
    chunks = [requests[i:i + 2] for i in range(0, 5, 2)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        ahead = list(infer_views(model, requests, eval_batch=2))
        assert launches()["K1"] == 4 * len(chunks)
        want = []
        with torch.inference_mode():
            for chunk in chunks:
                padded = chunk + [chunk[-1]] * (2 - len(chunk))
                out = model(*_inputs({
                    "imgs": np.stack([s["imgs"] for s in padded]),
                    "proj_matrices": {k: np.stack([s["proj_matrices"][k] for s in padded])
                                      for k in padded[0]["proj_matrices"]},
                    "depth_values": np.stack([s["depth_values"] for s in padded])},
                    cuda_device))
                for i in range(len(chunk)):
                    want.append((out["depth"][i:i + 1].cpu().numpy(),
                                 out["photometric_confidence"][i:i + 1].cpu().numpy()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert len(ahead) == len(want) == 5
    for (_, res), (depth, conf) in zip(ahead, want):
        np.testing.assert_array_equal(res["depth"], depth)
        np.testing.assert_array_equal(res["confidence"], conf)


@pytest.mark.cuda
@pytest.mark.parametrize("cut", list(SG_UPSTREAM))
def test_sg_cuts_on_the_card(cuda_device, cut):
    """One train step (batch 2, --ot_backend pallas, Adam) under each cut:
    zero gradients upstream of it, gradients downstream, K3 only where a
    gradient reaches the warped sources and K5 only where one reaches the
    attention (not under "logits")."""
    from mvster_tpu_torch.models.losses import mvs4net_loss

    model = MVS4Net(MVS4NetConfig.dtu_default(sg_cuts=() if cut == "none" else (cut,)))
    model.load_state_dict(init_state_dict(model, seed=1), strict=True)
    model.to(cuda_device)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), mvs4net_loss,
                           dict(LOSS_KW, ot_backend="pallas"))
    reset_launches()
    scalars, _ = step(torch_batch(plane_batch(BATCH, h=H, w=W), cuda_device))
    torch.cuda.synchronize()
    assert np.isfinite(float(scalars["loss"]))
    upstream = [k for k, _ in model.named_parameters() if k.startswith(SG_UPSTREAM[cut])]
    graded = {k for k, p in model.named_parameters() if p.grad is not None and p.grad.any()}
    assert bool(upstream) == bool(SG_UPSTREAM[cut]) and not graded & set(upstream)
    assert all(any(k.startswith(prefix) for k in graded) for prefix in SG_DOWNSTREAM[cut])
    k3 = PER_STEP if cut in ("none", "mono") else 0
    k5 = 0 if cut == "logits" else 4
    got = launches()
    assert (got["K1"], got["K2"], got["K3"], got["K4"], got["K5"]) == (0, PER_STEP, k3, 4, k5)


# ------------------------------------------------------------- data parallel

def _ddp_entry(out, argv):
    """In the process torchrun starts: tools.train.main(argv) with every
    count at 0 just before; its result and the counts to `out`."""
    from mvster_tpu_torch.data.dtu import DTUDataset
    from mvster_tpu_torch.tools import train

    DTUDataset._prepare_map = _half_map
    reset_launches()
    result = train.main(argv)
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump(dict(result, launches=launches()), f)


@pytest.mark.cuda
def test_torchrun_trains_over_nccl_on_the_card(cuda_device, dtu_tree, tmp_path):
    """python -m torch.distributed.run --standalone --nproc_per_node 1 of
    tools.train.main (--ot_backend pallas): a NCCL group of one, each
    kernel's launches, a checkpoint without DDP's `module.` keys that loads
    strictly and serves a request through 4 K1 launches."""
    from mvster_tpu_torch.tools.test import infer_views

    out = str(tmp_path / "ddp.json")
    argv = _train_argv(dtu_tree, str(tmp_path / "log"), ["--ot_backend", "pallas"])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", __file__, "ddp", out, *argv], env=_env(), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        res = json.load(f)
    assert (res["backend"], res["world_size"], res["rank"]) == ("nccl", 1, 0)
    steps, val_batches = SAMPLES // BATCH, -(-SAMPLES // BATCH)
    assert res["steps"] == steps and np.isfinite(res["val"]["loss"])
    assert res["launches"] == _expected_train_launches(steps, val_batches, "pallas", K6_PER_STEP)
    state = torch.load(res["checkpoint"], map_location="cpu", weights_only=True)["model"]
    assert not any(k.startswith("module.") for k in state)
    model = MVS4Net(MVS4NetConfig.dtu_default())
    model.load_state_dict(state, strict=True)
    reset_launches()
    served = list(infer_views(model.to(cuda_device).eval(), [_request(20)]))
    assert launches()["K1"] == 4 and np.isfinite(served[0][1]["depth"]).all()


def _gloo_batch(root):
    """The tree's first 4 training samples (numpy), the last two with the
    left half of every stage's mask cut, so the ranks' counts differ."""
    from mvster_tpu_torch.data import MVSLoader
    from mvster_tpu_torch.data.dtu import DTUDataset

    ds = DTUDataset(root, f"{root}/train.txt", "train", VIEWS, 1.06, seed=1)
    batch = next(iter(MVSLoader(ds, 2 * BATCH, prefetch=0)))
    batch = {k: v for k, v in batch.items() if not isinstance(v, (list, str))}
    batch["mask"] = {k: v.copy() for k, v in batch["mask"].items()}
    for v in batch["mask"].values():
        v[BATCH:, :, : v.shape[2] // 2] = 0
    return batch


def _shard(batch, rank):
    if isinstance(batch, dict):
        return {k: _shard(v, rank) for k, v in batch.items()}
    return batch[rank * BATCH:(rank + 1) * BATCH]


def _sgd_step(model, batch):
    """One SGD step (lr 1e-3, --ot_backend pallas) of `model` (or DDP of
    it): its scalars and the state after it."""
    from mvster_tpu_torch.models.losses import mvs4net_loss
    from mvster_tpu_torch.train.loop import device_batch

    module = getattr(model, "module", model)
    step = make_train_step(model, torch.optim.SGD(module.parameters(), lr=1e-3), mvs4net_loss,
                           dict(LOSS_KW, ot_backend="pallas"))
    scalars, _ = step(device_batch(batch, next(module.parameters()).device))
    return ({k: float(v) for k, v in scalars.items()},
            {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()})


def _initial_model(device):
    model = MVS4Net(MVS4NetConfig.dtu_default())
    model.load_state_dict(init_state_dict(model, seed=1), strict=True)
    return model.to(device)


def _gloo_rank(tmp):
    """One of two ranks on the one card: DDP over gloo, one SGD step on this
    rank's half of the batch."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rank, world = maybe_initialize_distributed(dev, backend="gloo")
    with open(os.path.join(tmp, "batch.pkl"), "rb") as f:
        batch = _shard(pickle.load(f), rank)
    model = DistributedDataParallel(_initial_model(dev), device_ids=[0], broadcast_buffers=False)
    scalars, state = _sgd_step(model, batch)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(dict(rank=rank, world=world, backend=dist.get_backend(), scalars=scalars,
                         state=state), f)
    dist.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_one_process(cuda_device, dtu_tree, tmp_path,
                                                      monkeypatch):
    """Two DDP processes on the one card over gloo, batch 2 each, against one
    process's step on the batch of 4: every scalar at rtol 1e-5 (the pixel
    fractions at atol 1e-4 more), the parameters at rtol 1e-2 / atol 1e-5,
    the BatchNorm running statistics bitwise equal across the ranks and at
    rtol 1e-4 / atol 1e-5 against the one process."""
    from mvster_tpu_torch.data.dtu import DTUDataset

    monkeypatch.setattr(DTUDataset, "_prepare_map", _half_map)
    tmp = str(tmp_path)
    batch = _gloo_batch(dtu_tree)
    with open(os.path.join(tmp, "batch.pkl"), "wb") as f:
        pickle.dump(batch, f)
    procs = spawn_ranks(__file__, ["gloo", tmp], 2)
    one, one_state = _sgd_step(_initial_model(cuda_device), batch)
    wait_ranks(procs)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    assert [(x["rank"], x["world"], x["backend"]) for x in ranks] == [(0, 2, "gloo"),
                                                                       (1, 2, "gloo")]
    for x in ranks:
        for key, want in one.items():
            atol = 1e-7 + (PIXEL_ATOL if key.startswith(PIXEL_FRACTIONS) else 0.0)
            assert abs(x["scalars"][key] - want) <= 1e-5 * abs(want) + atol, (key, x["rank"])
    a, b = ranks[0]["state"], ranks[1]["state"]
    for key, want in one_state.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"ranks differ: {key}")
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(a[key], want, rtol=1e-4, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(a[key], want, rtol=1e-2, atol=1e-5, err_msg=key)


# ------------------------------------------------------------- image-row sharding

def _spatial_model(state, overrides, dtype, device, mono):
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=mono, **overrides))
    model.load_state_dict(state, strict=True)
    return model.to(device, dtype)


def _gathered(out, groups):
    from mvster_tpu_torch.dist import spatial

    return {f"stage{s}": {k: spatial.gather_rows(out[f"stage{s}"][k], groups).cpu().numpy()
                          for k in STAGE_KEYS} for s in range(1, 5)}


def _spatial_rank(tmp):
    """One of two ranks on the one card over gloo, spatial 2, for each case
    of SPATIAL_CASES: the serve step in float32 (the kernels on, their
    launches) and in float64 (K1's and K7's plain versions), and one SGD
    step of the train step in float64 (the plain warp, --ot_backend xla)
    and in float32 (--ot_backend pallas, the kernels on, their launches)."""
    import torch.distributed as dist

    from mvster_tpu_torch.dist import spatial
    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    dev = torch.device("cuda", 0)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank, _ = maybe_initialize_distributed(dev, backend="gloo")
    groups = spatial.make_2d_groups(1, 2)
    out = {}
    for name, overrides in SPATIAL_CASES.items():
        res = out[name] = {}
        for dtype in (torch.float32, torch.float64):
            model = _spatial_model(inputs["serve"][name], overrides, dtype, dev, mono=False)
            outs = []
            hook = model.register_forward_hook(lambda mod, args, o: outs.append(o))
            reset_launches()
            with plain_eval() if dtype == torch.float64 else contextlib.nullcontext():
                depth, conf = spatial.make_spatial_infer_step(model, groups)(
                    *_inputs(inputs["sample"], "cpu", dtype))
            torch.cuda.synchronize()
            hook.remove()
            key = "serve64" if dtype == torch.float64 else "serve32"
            res[key] = dict(launches=launches(), depth=depth.cpu().numpy(),
                            conf=conf.cpu().numpy(), gathered=_gathered(outs[0], groups))
        for dtype, backend in ((torch.float64, "xla"), (torch.float32, "pallas")):
            model = _spatial_model(inputs["train"][name], overrides, dtype, dev, mono=True)
            step = spatial.make_spatial_train_step(
                model, torch.optim.SGD(model.parameters(), lr=1e-3), groups,
                loss_kwargs=dict(LOSS_KW, ot_backend=backend))
            reset_launches()
            with plain_warp() if dtype == torch.float64 else contextlib.nullcontext():
                scalars, images = step(_train_batch(inputs["batch"][name], dtype))
            torch.cuda.synchronize()
            key = "train64" if dtype == torch.float64 else "train32"
            res[key] = dict(
                launches=launches(), scalars={k: float(v) for k, v in scalars.items()},
                after={k: v.cpu().numpy() for k, v in model.state_dict().items()},
                depth_shape=tuple(images["depth_est"].shape),
                finite=bool(all(torch.isfinite(v).all() for v in images.values())))
            if rank == 0:
                res[key]["grads"] = _grads(model)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _train_batch(batch, dtype, device="cpu"):
    b = torch_batch(batch, device)
    return {k: ({s: x.to(dtype) for s, x in v.items()} if isinstance(v, dict) else v.to(dtype))
            for k, v in b.items()}


def _grads(model):
    return {k: p.grad.double().cpu().numpy() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def spatial_runs(cuda_device, tmp_path_factory):
    """Starts the two ranks once, computes one process's forwards and train
    steps of each case on the card while they run (float64 through the
    kernels' plain versions; float32 with the kernels on, its train step's
    BatchNorm under flax_moments), then reads the ranks' results."""
    tmp = str(tmp_path_factory.mktemp("spatial"))
    serve = {n: _seeded(MVS4NetConfig.dtu_default(mono=False, **o), 24).state_dict()
             for n, o in SPATIAL_CASES.items()}
    train = {n: _seeded(MVS4NetConfig.dtu_default(mono=True, **o), 24).state_dict()
             for n, o in SPATIAL_CASES.items()}
    sample = synthetic_sample(24, nviews=VIEWS, h=H, w=W)
    batches = {size: plane_batch(BATCH, *size) for size in set(SPATIAL_TRAIN_SIZE.values())}
    batch = {name: batches[size] for name, size in SPATIAL_TRAIN_SIZE.items()}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(dict(serve=serve, train=train, sample=sample, batch=batch), f)
    procs = spawn_ranks(__file__, ["spatial", tmp], 2)
    single = {}
    try:
        for name, overrides in SPATIAL_CASES.items():
            one = single[name] = {}
            for dtype, context in ((torch.float64, plain_eval), (torch.float32,
                                                                 contextlib.nullcontext)):
                model = _spatial_model(serve[name], overrides, dtype, cuda_device,
                                       mono=False).eval()
                with torch.inference_mode(), context():
                    out = to_numpy_tree(model(*_inputs(sample, cuda_device, dtype)))
                one["serve64" if dtype == torch.float64 else "serve32"] = out
            for dtype, backend, context in ((torch.float64, "xla", plain_warp),
                                            (torch.float32, "pallas", flax_moments)):
                model = _spatial_model(train[name], overrides, dtype, cuda_device, mono=True)
                step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3),
                                       loss_kwargs=dict(LOSS_KW, ot_backend=backend))
                with context():
                    scalars, _ = step(_train_batch(batch[name], dtype, cuda_device))
                one["train64" if dtype == torch.float64 else "train32"] = dict(
                    scalars={k: float(v) for k, v in scalars.items()}, grads=_grads(model))
    finally:
        wait_ranks(procs)
    ranks = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return dict(single=single, ranks=ranks,
                depth_range=(sample["depth_values"][0, 0], sample["depth_values"][0, -1]))


def _assert_f32_agree(want, got, depth_range):
    """F32_AGREE of each stage's windows and decisive depths; every value
    finite and stage 1's depth inside the hypotheses' range."""
    (dmin, dmax), d1 = depth_range, got["stage1"]["depth"]
    assert dmin * (1 - 1e-6) <= d1.min() and d1.max() <= dmax * (1 + 1e-6)
    for s in range(1, 5):
        w, o = want[f"stage{s}"], got[f"stage{s}"]
        assert all(np.isfinite(o[k]).all() for k in STAGE_KEYS), f"stage{s}"
        agree = np.all(np.isclose(o["hypo_depth"], w["hypo_depth"], rtol=1e-5), axis=1).mean()
        top2 = np.sort(w["attn_weight"], axis=1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 0.05
        same = np.isclose(o["depth"], w["depth"], rtol=1e-3, atol=1e-2)[decisive].mean()
        assert agree >= F32_AGREE and same >= F32_AGREE, (f"stage{s}", agree, same)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_serve_on_the_card_matches_one_process(spatial_runs, name):
    """make_spatial_infer_step as spatial 2: in float32 4 K1 launches a rank
    (4 K7 with dcn), each rank's band of the depth the forward gathers, and
    the gathered stage outputs against one process's float32 forward with
    the kernels on by F32_AGREE; in float64 the gathered stage outputs
    against one process's float64 forward by the stage comparator and every
    attention value within 1e-9."""
    single, ranks = spatial_runs["single"][name], spatial_runs["ranks"]
    k7 = 4 if SPATIAL_CASES[name].get("dcn") else 0
    for r, rank in enumerate(ranks):
        run = rank[name]["serve32"]
        assert run["launches"] == dict(K1=4, K2=0, K3=0, K4=0, K5=0, K6=0, K7=k7)
        assert run["depth"].shape == run["conf"].shape == (1, H // 2, W)
        assert np.isfinite(run["depth"]).all() and np.isfinite(run["conf"]).all()
        band = slice(r * H // 2, (r + 1) * H // 2)
        np.testing.assert_array_equal(run["depth"],
                                      run["gathered"]["stage4"]["depth"][:, band])
    _assert_f32_agree(single["serve32"], ranks[0][name]["serve32"]["gathered"],
                      spatial_runs["depth_range"])
    got = dict(ranks[0][name]["serve64"]["gathered"])
    got["depth"] = got["stage4"]["depth"]
    want = single["serve64"]
    assert_stage_close(want, got)
    for s in range(1, 5):
        np.testing.assert_allclose(got[f"stage{s}"]["attn_weight"],
                                   want[f"stage{s}"]["attn_weight"], rtol=0,
                                   atol=F64_ATTN_ATOL, err_msg=f"stage{s}")


def _assert_f32_scalars(got, want, window_rtol):
    for key, v in want.items():
        rtol = window_rtol if key in WINDOW_SCALARS else 1e-5
        atol = 1e-7 + (PIXEL_ATOL if key.startswith(PIXEL_FRACTIONS) else 0.0)
        assert abs(got[key] - v) <= rtol * abs(v) + atol, (key, got[key], v)


def _assert_f32_grads(got, got_exact, one, one_exact, per_tensor):
    """The float32 gradients of the bands (`got`, their float64 step
    `got_exact`) against one process's (`one`, `one_exact`): dtu_default's
    rule with `per_tensor`, a variant's without (see F32_NOISE_RATIO)."""
    e_sp, e_one = [], []
    for key, g_e in one_exact.items():
        assert np.isfinite(got[key]).all(), key
        if np.linalg.norm(g_e) < GRAD_NOISE:  # zero in exact arithmetic: no relative
            if per_tensor:  # distance, so the same rule on the absolute one
                sp = np.linalg.norm(got[key] - got_exact[key])
                ref = np.linalg.norm(one[key] - g_e)
                assert sp <= max(GRAD_NOISE, F32_NOISE_RATIO * ref), (key, sp, ref)
            continue
        sp, ref = relative_l2(got[key], got_exact[key]), relative_l2(one[key], g_e)
        if per_tensor:
            assert sp <= max(1e-4, F32_NOISE_RATIO * ref), (key, sp, ref)
            rel = relative_l2(got[key], one[key])
            assert rel <= max(1e-4, 1.5 * (sp + ref)), (key, rel, sp, ref)
        e_sp.append(sp)
        e_one.append(ref)
    ratio = F32_MEDIAN_RATIO if per_tensor else F32_NOISE_RATIO
    assert np.median(e_sp) <= ratio * np.median(e_one), (np.median(e_sp), np.median(e_one))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_train_step_on_the_card_matches_one_process(spatial_runs, name):
    """make_spatial_train_step as spatial 2, one SGD step (dtu_default at
    512x640): in float64 every
    scalar within rtol 1e-6 and every gradient within relative L2 1e-7 of
    one process's float64 step; in float32 (--ot_backend pallas) K2/K3 a
    stage and source, K4/K5 a stage (and K7 a head with dcn) a rank, finite
    images of each band, and the scalars and gradients against one
    process's float32 step with the kernels on and the ranks' BatchNorm
    arithmetic by the rules above; in both the ranks' parameters, running
    statistics and scalars bitwise equal."""
    single, ranks = spatial_runs["single"][name], spatial_runs["ranks"]
    k7 = 4 if SPATIAL_CASES[name].get("dcn") else 0
    h, w = SPATIAL_TRAIN_SIZE[name]
    want = {"train64": dict(K1=0, K2=0, K3=0, K4=0, K5=0, K7=0),
            "train32": dict(K1=0, K2=PER_STEP, K3=PER_STEP, K4=4, K5=4, K7=k7)}
    for kind, counts in want.items():
        runs = [rank[name][kind] for rank in ranks]
        for run in runs:
            assert {k: v for k, v in run["launches"].items() if k != "K6"} == counts, kind
            assert run["finite"] and run["depth_shape"] == (BATCH, h // 2, w), kind
            assert run["scalars"] == runs[0]["scalars"], kind
            for key, v in runs[0]["after"].items():
                np.testing.assert_array_equal(run["after"][key], v, err_msg=f"{kind} {key}")
    got, one = ranks[0][name]["train64"], single["train64"]
    for key, v in one["scalars"].items():
        assert abs(got["scalars"][key] - v) <= 1e-6 * abs(v) + 1e-7, key
    for key, g in one["grads"].items():
        if np.linalg.norm(g) < GRAD_NOISE:  # zero in exact arithmetic
            np.testing.assert_allclose(got["grads"][key], g, atol=1e-10, err_msg=key)
        else:
            assert relative_l2(got["grads"][key], g) <= F64_GRAD_RTOL, key
    got32 = ranks[0][name]["train32"]
    per_tensor = name == "dtu_default"
    _assert_f32_scalars(got32["scalars"], single["train32"]["scalars"],
                        WINDOW_RTOL if per_tensor else VARIANT_WINDOW_RTOL)
    _assert_f32_grads(got32["grads"], got["grads"], single["train32"]["grads"], one["grads"],
                      per_tensor)


if __name__ == "__main__":
    mode, *rest = sys.argv[1:]
    if mode == "ddp":
        _ddp_entry(rest[0], rest[1:])
    elif mode == "gloo":
        _gloo_rank(rest[0])
    elif mode == "spatial":
        _spatial_rank(rest[0])
    else:
        raise SystemExit(f"unknown mode {mode}")
