"""The port's config, networks, weights and eval forward against the JAX package.

Weights are random flax variables made with numpy from a seed
(_torch_parity.perturbed_variables), exported to the reference state-dict
grammar by tools.weights.state_dict_from_jax and loaded strictly.  The
forward runs on the textured-plane scene at 64x64 with 3 views.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import (
    assert_stage_close,
    jax_variables,
    run_jax_model,
    t,
    to_numpy_tree,
)
from helpers import plane_scene_sample
from mvster_tpu.models import MVS4NetConfig as JaxConfig
from mvster_tpu.nn.fpn import FPN4 as JaxFPN4
from mvster_tpu.nn.reg import Reg2d as JaxReg2d
from mvster_tpu_torch.config import MVS4NetConfig
from mvster_tpu_torch.models.mvs4net import MVS4Net
from mvster_tpu_torch.nn.fpn import FPN4
from mvster_tpu_torch.nn.reg import Reg2d
from mvster_tpu_torch.tools.weights import (
    init_state_dict,
    load_reference_ckpt,
    random_state_dict,
    state_dict_from_jax,
)


@pytest.fixture(scope="module")
def jax_setup():
    sample = plane_scene_sample(0)
    variables = jax_variables(JaxConfig.dtu_default(mono=False), sample, seed=0)
    return sample, variables


def _sub_state(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _forward(model, sample):
    with torch.no_grad():
        return to_numpy_tree(model(
            t(sample["imgs"]),
            {k: t(v) for k, v in sample["proj_matrices"].items()},
            t(sample["depth_values"]),
        ))


def test_config_fields_and_defaults_match_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(MVS4NetConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == theirs
    assert (dataclasses.asdict(MVS4NetConfig.dtu_default(mono=False))
            == dataclasses.asdict(JaxConfig.dtu_default(mono=False)))


@pytest.mark.parametrize("override", [
    dict(arch_mode="convnext"), dict(reg_net="reg3d"), dict(dcn=True),
    dict(pos_enc=1), dict(asff=True), dict(agg_type="ConvBnReLU3D_CAM"),
    dict(compute_dtype="bfloat16"),
])
def test_variant_configs_construct_and_load_strictly(override):
    """The configs the port once refused now run: each constructs, and
    loads its own random_state_dict and its init_state_dict strictly."""
    config = MVS4NetConfig.dtu_default(mono=False, **override)
    assert config.unsupported() == []
    model = MVS4Net(config)
    model.load_state_dict(random_state_dict(model, seed=0), strict=True)
    model.load_state_dict(init_state_dict(model, seed=0), strict=True)


def test_tpu_formulation_flags_are_accepted_and_change_nothing():
    a = MVS4Net(MVS4NetConfig.dtu_default(mono=False))
    b = MVS4Net(MVS4NetConfig.dtu_default(mono=False, reg2d_fold=False,
                                          fpn_compose=False, warp_impl="xla"))
    assert a.state_dict().keys() == b.state_dict().keys()


def test_strict_load_of_state_dict_from_jax(jax_setup):
    _, variables = jax_setup
    sd = state_dict_from_jax(variables)
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False))
    model.load_state_dict(sd, strict=True)
    # layouts: conv HWIO -> OIHW, and the pre-flipped transposed conv back
    kernel = variables["params"]["feature"]["conv1_0"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        model.feature.conv1[0].conv.weight.detach().numpy(),
        np.transpose(kernel, (3, 2, 0, 1)))
    dkernel = variables["params"]["reg_2"]["conv7"]["kernel"]  # (1, 3, 3, I, O) flipped
    np.testing.assert_array_equal(
        model.reg[2].conv7[0].weight.detach().numpy(),
        np.transpose(dkernel[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))


@pytest.mark.parametrize("compose_tail,atol", [(False, 1e-4), (True, 5e-4)])
def test_fpn4_matches_jax(jax_setup, compose_tail, atol):
    _, variables = jax_setup
    imgs = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = JaxFPN4(8, compose_tail=compose_tail).apply(
        {"params": variables["params"]["feature"],
         "batch_stats": variables["batch_stats"]["feature"]},
        jnp.asarray(imgs), False,
    )
    fpn = FPN4(8)
    fpn.load_state_dict(_sub_state(state_dict_from_jax(variables), "feature."),
                        strict=True)
    with torch.no_grad():
        got = fpn.eval()(t(imgs).permute(0, 3, 1, 2))
    for key in ("stage1", "stage2", "stage3", "stage4"):
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[key]), rtol=1e-4, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("fold,atol", [(False, 1e-4), (True, 5e-4)])
def test_reg2d_matches_jax(jax_setup, fold, atol):
    _, variables = jax_setup
    vol = np.random.default_rng(2).normal(size=(1, 4, 16, 24, 4)).astype(np.float32)
    want = JaxReg2d(8, fold=fold).apply(
        {"params": variables["params"]["reg_3"],
         "batch_stats": variables["batch_stats"]["reg_3"]},
        jnp.asarray(vol), False,
    )
    reg = Reg2d(4, 8)
    reg.load_state_dict(_sub_state(state_dict_from_jax(variables), "reg.3."),
                        strict=True)
    with torch.no_grad():
        got = reg.eval()(t(vol).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=atol)


# the JAX default config runs its folded reg2d and composed FPN tail, which
# reassociate the sums; with both off it runs the port's formulation
@pytest.mark.parametrize("overrides,atol", [
    (dict(), 2e-3),
    (dict(reg2d_fold=False, fpn_compose=False), 1e-3),
])
def test_eval_forward_matches_jax(jax_setup, overrides, atol):
    sample, variables = jax_setup
    want = run_jax_model(JaxConfig.dtu_default(mono=False, **overrides),
                         variables, sample)
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False, **overrides)).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = _forward(model, sample)
    assert_stage_close(want, got, atol=atol)
    for s in range(1, 5):
        key = f"stage{s}"
        # the JAX package's warp_fallbacks counts XLA fallbacks; the port has none
        assert got[key].keys() == want[key].keys() - {"warp_fallbacks"}
        np.testing.assert_allclose(got[key]["photometric_confidence"],
                                   want[key]["photometric_confidence"], atol=atol)
    assert got["depth"].shape == (1, 64, 64)


def test_forward_needs_eval_mode_and_64_multiples():
    """Eval mode runs the fused K1 route; train mode (now ported) the
    differentiable K2/K3 route and, with mono, the decoder; both take only
    multiples of 64."""
    from mvster_tpu_torch.kernels import cost_volume

    model = MVS4Net(MVS4NetConfig.dtu_default())
    model.load_state_dict(random_state_dict(model, seed=0), strict=True)
    routes = []
    real = cost_volume.build_cost_volume

    def spy(*args, **kw):
        routes.append(kw["impl"])
        return real(*args, **kw)

    sample = plane_scene_sample(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("mvster_tpu_torch.models.mvs4net.build_cost_volume", spy)
        train_out = model.train()(t(sample["imgs"]),
                                  {k: t(v) for k, v in sample["proj_matrices"].items()},
                                  t(sample["depth_values"]))
        eval_out = _forward(model.eval(), sample)
    assert routes == ["warp"] * 4 + ["fused"] * 4
    assert [k for k in train_out["stage4"] if k.startswith("mono")] == ["mono_feat", "mono_depth"]
    assert "mono_depth" not in eval_out["stage4"]
    assert train_out["stage4"]["mono_depth"].shape == (1, 64, 64)
    with pytest.raises(ValueError, match="multiples of 64"):
        _forward(model.eval(), plane_scene_sample(0, h=64, w=96))


def test_train_batchnorm_updates_running_stats_as_flax():
    """flax's BatchNorm (momentum 0.9) moves running_var toward the biased
    batch variance, where torch's own BatchNorm takes the unbiased one; at
    n = 2 * 3 * 3 values per channel the two differ by 9/8.  atol 1e-6."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from mvster_tpu_torch.nn.blocks import BatchNorm2d

    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, size=(2, 3, 3, 4)).astype(np.float32)  # NHWC
    mean0 = rng.normal(size=4).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=4).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=4).astype(np.float32)
    bias = rng.normal(size=4).astype(np.float32)
    y_jax, state = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm2d(4, eps=1e-5, momentum=0.1)
    bn.load_state_dict({"weight": t(scale), "bias": t(bias), "running_mean": t(mean0),
                        "running_var": t(var0), "num_batches_tracked": torch.tensor(0)})
    y = bn.train()(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_jax),
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(state["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(state["batch_stats"]["var"]), atol=1e-6)
    unbiased = 0.9 * var0 + 0.1 * x.reshape(-1, 4).var(axis=0, ddof=1)
    assert not np.allclose(bn.running_var.numpy(), unbiased, atol=1e-3)


@pytest.mark.parametrize("mono", [False, True])
def test_load_reference_ckpt(tmp_path, mono):
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False))
    sd = random_state_dict(model, seed=3)
    ckpt = {"epoch": 15, "model": {"module." + k: v for k, v in sd.items()}}
    ckpt["model"]["module.mono_depth_decoder.convblocks.0.conv.weight"] = torch.zeros(2)
    path = tmp_path / "model.ckpt"
    torch.save(ckpt, path)
    loaded = load_reference_ckpt(str(path), MVS4NetConfig.dtu_default(mono=mono))
    mono_keys = [k for k in loaded if k.startswith("mono_depth_decoder.")]
    assert bool(mono_keys) == mono
    if not mono:
        model.load_state_dict(loaded, strict=True)


def test_random_state_dict_is_seeded_and_loads_strictly():
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False))
    a, b, c = (random_state_dict(model, seed) for seed in (7, 7, 8))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["reg.0.prob.weight"], c["reg.0.prob.weight"])
    model.load_state_dict(a, strict=True)
