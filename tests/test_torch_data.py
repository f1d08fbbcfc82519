"""The port's own weight exporter and data layer against the JAX package's.

  - tools/convert.export_state_dict gives exactly the dict (keys, shapes,
    bit-equal values) that mvster_tpu.tools.convert_torch_ckpt's does, on
    the flax variables of the full dtu_default() with mono, initialised in
    train mode so the mono_depth_decoder.* keys are there.
  - data/: DTUDataset samples (train with robust training and colour
    jitter, and val) equal the JAX package's array for array, for the same
    seed and epoch, on a synthetic DTU tree written by the port's writer
    (_torch_parity.write_dtu_tree); PFM round trips equal across packages;
    the loader's batches equal; BlendedMVSDataset samples (robust training
    on, same seed and epoch, and off) equal the JAX package's on a synthetic
    BlendedMVS tree (_torch_parity.write_blendedmvs_tree); the Tanks and
    ETH3D test loaders equal the JAX package's on synthetic trees
    (_torch_parity.write_tanks_tree, write_eth3d_tree), both splits of
    Tanks, and raise as they do when a scan of the split is missing.
"""

import numpy as np
import pytest

from _torch_parity import (
    jax_train_variables,
    plane_batch,
    write_blendedmvs_tree,
    write_dtu_tree,
    write_eth3d_tree,
    write_tanks_tree,
)
from mvster_tpu_torch.data import MVSLoader, find_dataset_def
from mvster_tpu_torch.data.common import nearest_resize
from mvster_tpu_torch.data.pfm import read_pfm, write_pfm


def test_export_state_dict_equals_the_jax_exporter():
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu.tools.convert_torch_ckpt import export_state_dict as jax_export
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.convert import export_state_dict

    variables = jax_train_variables(JaxConfig.dtu_default(), plane_batch(1), seed=4)
    want = jax_export(variables)
    got = export_state_dict(variables)
    assert got.keys() == want.keys()
    assert any(k.startswith("mono_depth_decoder.conv3x3.") for k in got)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    # and the port's dtu_default() model (mono on) takes it strictly
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    MVS4Net(MVS4NetConfig.dtu_default()).load_state_dict(
        state_dict_from_jax(variables), strict=True)


def test_pfm_round_trip_equals_the_jax_package(tmp_path):
    from mvster_tpu.data.pfm import read_pfm as jax_read_pfm
    from mvster_tpu.data.pfm import write_pfm as jax_write_pfm

    rng = np.random.default_rng(0)
    for shape in ((13, 17), (5, 7, 3)):
        img = rng.normal(size=shape).astype(np.float32)
        ours, theirs = str(tmp_path / "ours.pfm"), str(tmp_path / "theirs.pfm")
        write_pfm(ours, img)
        jax_write_pfm(theirs, img)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
        back, scale = read_pfm(theirs)
        np.testing.assert_array_equal(back, img)
        np.testing.assert_array_equal(jax_read_pfm(ours)[0], back)
        assert scale == 1.0


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    write_dtu_tree(root, n_views=4, h=64, w=80)
    return root


def _half(hr):  # module-level: the loader pickles datasets into workers
    return nearest_resize(hr, hr.shape[0] // 2, hr.shape[1] // 2)


def _datasets(root, mode, **kw):
    import mvster_tpu.data as jax_data

    pair = []
    for find in (find_dataset_def, jax_data.find_dataset_def):
        ds = find("dtu")(root, f"{root}/train.txt", mode, 3, 1.06, **kw)
        ds._prepare_map = _half  # the synthetic maps are 2x the images, no crop
        pair.append(ds)
    return pair


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("mode,kw", [("train", dict(rt=True, seed=5)),
                                     ("val", dict())])
def test_dtu_dataset_equals_the_jax_package(dtu_tree, mode, kw):
    ours, theirs = _datasets(dtu_tree, mode, **kw)
    assert len(ours) == len(theirs) == 4 * 7
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for idx in (0, 9, 27):
            _assert_same_tree(ours[idx], theirs[idx], f"{mode} e{epoch} #{idx}")
    sample = ours[0]
    assert sample["imgs"].shape == (3, 64, 80, 3)
    assert sample["depth"]["stage1"].shape == (8, 10)


def test_loader_batches_equal_the_jax_package(dtu_tree):
    import mvster_tpu.data as jax_data

    ours, theirs = _datasets(dtu_tree, "train", rt=True, seed=2)
    a = MVSLoader(ours, 3, shuffle=True, drop_last=True, seed=2, prefetch=2)
    b = jax_data.MVSLoader(theirs, 3, shuffle=True, drop_last=True, seed=2, prefetch=0)
    a.set_epoch(1)
    b.set_epoch(1)
    got, want = list(a), list(b)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        _assert_same_tree(g, w)


@pytest.fixture(scope="module")
def blended_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blended"))
    write_blendedmvs_tree(root, n_views=5, h=96, w=128)
    return root


@pytest.mark.parametrize("split,kw", [("train", dict(robust_train=True, seed=4)),
                                      ("val", dict(robust_train=False))])
def test_blendedmvs_dataset_equals_the_jax_package(blended_tree, split, kw):
    import mvster_tpu.data as jax_data

    args = (blended_tree, f"{blended_tree}/train.txt", split, 3)
    ours = find_dataset_def("blendedmvs")(*args, **kw)
    theirs = jax_data.find_dataset_def("blendedmvs")(*args, **kw)
    assert len(ours) == len(theirs) == 5
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for idx in (0, 3):
            _assert_same_tree(ours[idx], theirs[idx], f"{split} e{epoch} #{idx}")
    sample = ours[1]
    assert sample["imgs"].shape == (3, 96, 128, 3)
    # the GT maps at the loader's 768x576, the range scaled by 100 / depth_min
    assert sample["depth"]["stage1"].shape == (72, 96)
    assert sample["depth"]["stage4"].shape == (576, 768)
    dmin, dmax = sample["depth_values"]
    assert (80.0 <= dmin <= 125.0) if kw["robust_train"] else dmin == 100.0
    assert dmax > dmin and sample["mask"]["stage4"].sum() > 0


@pytest.fixture(scope="module")
def tanks_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tanks"))
    for split in ("intermediate", "advanced"):
        write_tanks_tree(root, split, n_views=3, h=120, w=96)  # 1080 -> 1024 as 120 -> 64
    return root


@pytest.mark.parametrize("split", ["intermediate", "advanced"])
def test_tanks_dataset_equals_the_jax_package(tanks_tree, split):
    import mvster_tpu.data as jax_data

    ours = find_dataset_def("tanks")(tanks_tree, n_views=3, split=split)
    theirs = jax_data.find_dataset_def("tanks")(tanks_tree, n_views=3, split=split)
    n_scans = 8 if split == "intermediate" else 6
    assert ours.metas == theirs.metas and len(ours) == 3 * n_scans
    for idx in (0, 4, len(ours) - 1):
        _assert_same_tree(ours[idx], theirs[idx], f"{split} #{idx}")
    sample = ours[0]
    assert sample["imgs"].shape == (3, 64, 96, 3)
    k1 = sample["proj_matrices"]["stage1"][0, 1]  # cy - 28, at the stage-1 basis
    np.testing.assert_allclose(k1[1, 2], (60 - 28) * 0.125, rtol=1e-6)
    assert sample["depth_values"].tolist() == [425.0, pytest.approx(935.72)]


def test_tanks_dataset_raises_for_a_missing_scan(tanks_tree, tmp_path):
    import shutil

    import mvster_tpu.data as jax_data

    root = str(tmp_path / "partial")
    shutil.copytree(tanks_tree, root)
    shutil.rmtree(f"{root}/intermediate/Horse")
    for find in (find_dataset_def, jax_data.find_dataset_def):
        with pytest.raises(FileNotFoundError, match="Horse"):
            find("tanks")(root, n_views=3, split="intermediate")


@pytest.fixture(scope="module")
def eth3d_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eth3d"))
    write_eth3d_tree(root, n_views=3, h=120, w=192)
    return root


@pytest.mark.parametrize("img_wh", [(256, 128), (128, 64)])
def test_eth3d_dataset_equals_the_jax_package(eth3d_tree, img_wh):
    import mvster_tpu.data as jax_data

    ours = find_dataset_def("eth3d")(eth3d_tree, n_views=3, img_wh=img_wh)
    theirs = jax_data.find_dataset_def("eth3d")(eth3d_tree, n_views=3, img_wh=img_wh)
    assert ours.metas == theirs.metas and len(ours) == 3 * 12
    for idx in (0, 3, 7, len(ours) - 1):  # even scans' cams say depth_min -1, odd 1.5
        _assert_same_tree(ours[idx], theirs[idx], f"{img_wh} #{idx}")
    assert ours[0]["depth_values"][0] == 1.0 and ours[3]["depth_values"][0] == 1.5
    assert ours[0]["imgs"].shape == (3, img_wh[1], img_wh[0], 3)


def test_eth3d_dataset_raises_for_a_missing_scan(eth3d_tree, tmp_path):
    import shutil

    import mvster_tpu.data as jax_data

    root = str(tmp_path / "partial")
    shutil.copytree(eth3d_tree, root)
    shutil.rmtree(f"{root}/statue")
    for find in (find_dataset_def, jax_data.find_dataset_def):
        with pytest.raises(FileNotFoundError, match="statue"):
            find("eth3d")(root, n_views=3)
