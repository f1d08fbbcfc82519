"""The port's training: it learns, accumulates gradients exactly, and its tool runs.

  - learns: tests/test_training_learns.py's single-device case through the
    port on the CPU (plain warp and scatter), from weights drawn as flax
    draws them (tools/weights.init_state_dict): 60 Adam steps on two
    textured planes must cut the final-stage abs depth error 5x and the
    loss to under 0.7x, as that test asserts.
  - grad_accum=2 against a hand loop (per-microbatch backward at the
    initial parameters, mean gradient, one update), as
    tests/test_grad_accum.py checks the JAX step: loss rtol 1e-6,
    parameters and BatchNorm statistics atol 1e-6.
  - tools.train.main on a 64x128 synthetic DTU tree (the model takes
    multiples of 64), --device cpu, 2 steps of batch 3: JSONL log and
    checkpoint written, the checkpoint reloads strictly, --resume runs the
    next epoch with Adam's state carried over, --mode profile writes a
    torch.profiler trace; without --device, main raises on a machine with
    no card, and so does tools.test.main.
  - the BlendedMVS fine-tune: --dataset blendedmvs picks BlendedMVSDataset
    (robust training for train only) and blend_loss; tools.train.main with
    --ot_backend pallas from a --loadckpt on a 64x128 synthetic BlendedMVS
    tree (the loader's GT size cut to the images'), --device cpu, 2 steps of
    batch 2: finite loss, EPE, err1 and err3 in train and val, and every
    parameter but the mono decoder's (weighted 0) moved.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import plane_batch, torch_batch, write_blendedmvs_tree, write_dtu_tree
from mvster_tpu_torch.config import MVS4NetConfig
from mvster_tpu_torch.dist.train_step import make_train_step
from mvster_tpu_torch.models.losses import mvs4net_loss
from mvster_tpu_torch.models.mvs4net import MVS4Net
from mvster_tpu_torch.tools.weights import init_state_dict

LEARN_CFG = MVS4NetConfig(
    group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
    fpn_base_channel=4, reg_channel=4, attn_temp=2.0, mono=True,
)
LOSS_KW = dict(inverse_depth=True, ot_iter=10, mono=True)


def test_training_learns_on_the_cpu():
    torch.manual_seed(0)
    model = MVS4Net(LEARN_CFG)
    model.load_state_dict(init_state_dict(model, seed=0), strict=True)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                           loss_kwargs=LOSS_KW)
    batch = torch_batch(plane_batch(2))
    errs, losses = [], []
    for _ in range(60):
        scalars, _ = step(batch)
        errs.append(float(scalars["abs_depth_error"]))
        losses.append(float(scalars["loss"]))
    errs, losses = np.array(errs), np.array(losses)
    assert np.isfinite(losses).all(), "loss diverged"
    start, end = errs[:3].mean(), errs[-3:].mean()
    assert end < start / 5, f"abs depth error did not drop: {start:.2f} -> {end:.2f}"
    assert losses[-3:].mean() < 0.7 * losses[:3].mean(), (losses[:3], losses[-3:])


def test_grad_accum_matches_the_hand_loop():
    from helpers import synthetic_sample

    s = synthetic_sample(0, batch=2, nviews=3, h=64, w=64, with_gt=True)
    batch = torch_batch({k: s[k] for k in ("imgs", "proj_matrices", "depth_values",
                                           "depth", "mask")})
    cfg = MVS4NetConfig.dtu_default()
    init = init_state_dict(MVS4Net(cfg), seed=1)
    kw = dict(inverse_depth=True, ot_iter=4, mono=True)

    model = MVS4Net(cfg)
    model.load_state_dict(init)
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    scalars, images = make_train_step(model, opt, loss_kwargs=kw, grad_accum=2)(batch)

    ref = MVS4Net(cfg)
    ref.load_state_dict(init)
    ref.train()
    ref_opt = torch.optim.SGD(ref.parameters(), lr=1e-2)
    ref_opt.zero_grad()
    losses = []
    for i in range(2):
        mb = {k: ({s: v[s][i:i + 1] for s in v} if isinstance(v, dict) else v[i:i + 1])
              for k, v in batch.items()}
        out = ref(mb["imgs"], mb["proj_matrices"], mb["depth_values"])
        loss, _ = mvs4net_loss(out, mb["depth"], mb["mask"], **kw)
        (loss / 2).backward()
        losses.append(loss.item())
    ref_opt.step()

    np.testing.assert_allclose(float(scalars["loss"]), np.mean(losses), rtol=1e-6)
    assert images["depth_est"].shape[0] == 2
    for (key, got), want in zip(model.state_dict().items(), ref.state_dict().values()):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6, err_msg=key)


def test_grad_accum_rejects_an_indivisible_batch():
    model = MVS4Net(MVS4NetConfig.dtu_default())
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                           grad_accum=2)
    batch = torch_batch(plane_batch(1))
    with pytest.raises(ValueError, match="microbatches"):
        step(batch)


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    write_dtu_tree(root, n_views=3, h=64, w=128, n_refs=1)  # 7 samples
    return root


TRAIN_FLAGS = ["--nviews", "3", "--batch_size", "3", "--epochs", "1",
               "--group_cor", "--inverse_depth", "--mono", "--attn_temp", "2",
               "--summary_freq", "1", "--seed", "3"]


def _half(hr):
    from mvster_tpu_torch.data.common import nearest_resize

    return nearest_resize(hr, hr.shape[0] // 2, hr.shape[1] // 2)


def test_train_main_on_the_cpu(dtu_tree, tmp_path, monkeypatch):
    from mvster_tpu_torch.data.dtu import DTUDataset
    from mvster_tpu_torch.tools import train
    from mvster_tpu_torch.tools.weights import load_reference_ckpt

    # the synthetic maps are 2x the 64x128 images: no 512x640 crop
    monkeypatch.setattr(DTUDataset, "_prepare_map", lambda self, hr: _half(hr))
    logdir = str(tmp_path / "log")
    result = train.main(["--trainpath", dtu_tree, "--trainlist", f"{dtu_tree}/train.txt",
                         "--testlist", f"{dtu_tree}/train.txt", "--logdir", logdir,
                         "--device", "cpu", *TRAIN_FLAGS])
    assert result["steps"] == 2
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    train_recs = [r for r in records if r["mode"] == "train"]
    assert [r["step"] for r in train_recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert any(r["mode"] == "fulltest" for r in records)
    assert result["checkpoint"] == os.path.join(logdir, "model_000000.ckpt")
    state = torch.load(result["checkpoint"], weights_only=True)
    assert set(state) == {"epoch", "model", "optimizer"} and state["epoch"] == 0
    model = MVS4Net(MVS4NetConfig.dtu_default())
    model.load_state_dict(load_reference_ckpt(result["checkpoint"],
                                              MVS4NetConfig.dtu_default()), strict=True)

    # --resume continues from that checkpoint: epoch 1 only, Adam's state kept
    resumed = train.main(["--trainpath", dtu_tree, "--trainlist", f"{dtu_tree}/train.txt",
                          "--testlist", f"{dtu_tree}/train.txt", "--logdir", logdir,
                          "--device", "cpu", "--resume", *TRAIN_FLAGS, "--epochs", "2"])
    assert resumed["steps"] == 2
    assert resumed["checkpoint"] == os.path.join(logdir, "model_000001.ckpt")
    state = torch.load(resumed["checkpoint"], weights_only=True)
    assert state["epoch"] == 1
    assert all(int(s["step"]) == 4 for s in state["optimizer"]["state"].values())


def test_train_main_profile_mode_writes_a_trace(dtu_tree, tmp_path, monkeypatch):
    from mvster_tpu_torch.data.dtu import DTUDataset
    from mvster_tpu_torch.tools import train

    monkeypatch.setattr(DTUDataset, "_prepare_map", lambda self, hr: _half(hr))
    result = train.main(["--trainpath", dtu_tree, "--trainlist", f"{dtu_tree}/train.txt",
                         "--testlist", f"{dtu_tree}/train.txt", "--logdir", str(tmp_path),
                         "--device", "cpu", "--mode", "profile", *TRAIN_FLAGS])
    assert result["profile"] == os.path.join(str(tmp_path), "profile", "train_steps.json")
    trace = json.load(open(result["profile"]))
    assert any("conv" in e.get("name", "") for e in trace["traceEvents"])


def test_train_main_needs_a_card_unless_asked_for_the_cpu(dtu_tree, tmp_path):
    from mvster_tpu_torch.tools import test as test_tool
    from mvster_tpu_torch.tools import train

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    argv = ["--trainpath", dtu_tree, "--trainlist", f"{dtu_tree}/train.txt",
            "--testlist", f"{dtu_tree}/train.txt", "--logdir", str(tmp_path), *TRAIN_FLAGS]
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(argv)
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_tool.main(["--testpath", dtu_tree, "--testlist", "scan1",
                        "--loadckpt", "missing.ckpt"])


def test_blendedmvs_picks_its_dataset_and_blend_loss(tmp_path):
    from mvster_tpu_torch.data.blendedmvs import BlendedMVSDataset
    from mvster_tpu_torch.models.losses import blend_loss
    from mvster_tpu_torch.tools import train
    from mvster_tpu_torch.tools.cli import build_train_parser

    root = str(tmp_path)
    write_blendedmvs_tree(root, n_views=4, h=64, w=128)
    args = build_train_parser().parse_args(
        ["--dataset", "blendedmvs", "--trainpath", root, "--trainlist", f"{root}/train.txt",
         "--testlist", f"{root}/train.txt", "--nviews", "3", "--rt", "--seed", "2"])
    train_ds, val_ds = train.build_datasets(args)
    assert type(train_ds) is type(val_ds) is BlendedMVSDataset
    assert (train_ds.robust_train, val_ds.robust_train, train_ds.seed) == (True, False, 2)
    assert len(train_ds) == len(val_ds) == 4
    assert train.select_loss("blendedmvs") is blend_loss
    assert train.select_loss("dtu") is train.select_loss("dtu_yao4") is mvs4net_loss


def test_train_main_blendedmvs_fine_tune_on_the_cpu(tmp_path, monkeypatch):
    from mvster_tpu_torch.data.blendedmvs import BlendedMVSDataset
    from mvster_tpu_torch.tools import train
    from mvster_tpu_torch.tools.weights import load_reference_ckpt

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
    result = train.main(["--dataset", "blendedmvs", "--trainpath", root,
                         "--trainlist", f"{root}/train.txt", "--testlist", f"{root}/train.txt",
                         "--logdir", logdir, "--loadckpt", ckpt, "--ot_backend", "pallas",
                         "--rt", "--device", "cpu", *TRAIN_FLAGS, "--batch_size", "2"])
    assert result["steps"] == 2
    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    assert {r["mode"] for r in records} == {"train", "fulltest"}
    for r in records:
        for key in ("loss", "epe", "err1", "err3"):
            assert np.isfinite(r[key]), (r["mode"], key)
    trained = load_reference_ckpt(result["checkpoint"], config)
    params = {name for name, _ in MVS4Net(config).named_parameters()}
    moved = {k for k in params if not torch.equal(trained[k], start[k])}
    assert moved == {k for k in params if not k.startswith("mono_depth_decoder.")}
