"""The port's model-variant modules against the JAX package's, one by one.

Each flax module gets random variables made with numpy from a seed
(_torch_parity.perturbed_variables), exported to the reference state-dict
grammar by the port's tools/convert.py and loaded strictly into the port's
module; the same numpy inputs go through both, at rtol 1e-5 and atol 1e-5 of the
output's largest magnitude (float32):
the four attention blocks, the (3, 3, 3) stride-2 transposed conv, Reg3d
at down sizes 1, 2 and 3 (in eval and in train mode, with the running
statistics), both depth positional encodings, ASFF at levels 0-3, both
ConvNeXt pyramids and the deformable conv with non-zero offset and
modulation convs.  Also: train-mode BatchNorm where a channel holds one
value, the exporter's transposed-conv flip, and every variant's weights
through the port's exporter and back through the JAX package's importer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import perturbed_variables, t
from mvster_tpu_torch.tools.convert import export_state_dict

TOL = dict(atol=1e-5, rtol=1e-5)


def _variables(module, *inputs, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw))
    return perturbed_variables(shapes, seed)


def _port_state(variables, jax_path, torch_prefix):
    """The port's state dict of the submodule that sits at `jax_path` of the
    model's flax tree and at `torch_prefix` of its state dict."""
    def nest(tree):
        for name in reversed(jax_path):
            tree = {name: tree}
        return tree

    sd = export_state_dict({c: nest(v) for c, v in variables.items() if v})
    assert all(k.startswith(torch_prefix) for k in sd), sorted(sd)[:4]
    return {k[len(torch_prefix):]: torch.from_numpy(np.array(v))
            for k, v in sd.items()}


def _ndhwc(x):  # port (B, C, D, H, W) -> (B, D, H, W, C)
    return x.detach().permute(0, 2, 3, 4, 1).numpy()


def _ncdhw(x):  # numpy (B, D, H, W, C) -> port (B, C, D, H, W)
    return t(x).permute(0, 4, 1, 2, 3).contiguous()


def _close(got, want, what=""):
    """rtol 1e-5, atol 1e-5 of the largest |want| or of 1: a float32 sum of
    terms as large as the output carries that much absolute rounding."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, err_msg=what, rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale)


def _train_apply(module, variables, *inputs):
    out, state = module.apply(variables, *inputs, True, mutable=["batch_stats"])
    return out, state["batch_stats"]


def _check_running_stats(port, jax_stats, jax_path, torch_prefix):
    want = _port_state({"batch_stats": jax_stats}, jax_path, torch_prefix)
    got = port.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            _close(got[key].numpy(), value.numpy(), key)


# ---- train-mode BatchNorm where a channel holds one value

def test_batchnorm_one_value_per_channel_matches_flax():
    """A (1, C, 1, 1, 1) volume in train mode (Reg3d's deepest level at
    small sizes): flax takes mean x and variance 0, so the output is the
    shift; F.batch_norm refuses it.  Output and running statistics."""
    import flax.linen as fnn

    from mvster_tpu_torch.nn.blocks import BatchNorm3d

    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 1, 1, 1, 6)).astype(np.float32)  # NDHWC
    mean0, bias = rng.normal(size=(2, 6)).astype(np.float32)
    var0, scale = rng.uniform(0.5, 1.5, size=(2, 6)).astype(np.float32)
    y_jax, state = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm3d(6, eps=1e-5, momentum=0.1)
    bn.load_state_dict({"weight": t(scale), "bias": t(bias), "running_mean": t(mean0),
                        "running_var": t(var0), "num_batches_tracked": torch.tensor(0)})
    xt = _ncdhw(x).requires_grad_()
    y = bn.train()(xt)
    _close(_ndhwc(y), y_jax, "output")
    _close(bn.running_mean.numpy(), state["batch_stats"]["mean"], "running_mean")
    _close(bn.running_var.numpy(), state["batch_stats"]["var"], "running_var")
    y.sum().backward()
    assert torch.isfinite(xt.grad).all()


# ---- 3D blocks

ATTENTION = ["ConvBnReLU3D_CAM", "ConvBnReLU3D_DCAM", "ConvBnReLU3D_PAM",
             "ConvBnReLU3D_PDAM"]


@pytest.mark.parametrize("agg_type", ATTENTION)
@pytest.mark.parametrize("train", [False, True])
def test_attention_block_matches_jax(agg_type, train):
    """Each attention block at (B, D, H, W, C) = (2, 4, 8, 12, 8), with the
    input and parameter gradients of a random cotangent in train mode."""
    from mvster_tpu.nn import blocks as jax_blocks
    from mvster_tpu_torch.nn import blocks

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 8, 12, 8)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jmod = getattr(jax_blocks, agg_type)(8)
    variables = _variables(jmod, jnp.asarray(x), seed=2)
    port = getattr(blocks, agg_type)(8, 8)
    port.load_state_dict(_port_state(variables, ("reg_0", "conv2"), "reg.0.conv2."),
                         strict=True)
    port.train(train)
    xt = _ncdhw(x).requires_grad_()
    y = port(xt)
    if not train:
        _close(_ndhwc(y), jmod.apply(variables, jnp.asarray(x), False))
        return

    def loss(params, inp):
        out, stats = _train_apply(jmod, {"params": params,
                                         "batch_stats": variables["batch_stats"]}, inp)
        return jnp.sum(out * cot), (out, stats)

    (_, (want, stats)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    _close(_ndhwc(y), want, "output")
    _check_running_stats(port, stats, ("reg_0", "conv2"), "reg.0.conv2.")
    (y * _ncdhw(cot)).sum().backward()
    _close(_ndhwc(xt.grad), g_x, "input gradient")
    want_g = _port_state({"params": g_params}, ("reg_0", "conv2"), "reg.0.conv2.")
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_transposed_conv_222_matches_jax():
    """Reg3d's upsampling block, (3, 3, 3) with stride (2, 2, 2): torch's
    padding 1 and output_padding 1 against the JAX input-dilated form."""
    from mvster_tpu.nn.blocks import ConvTransposeBnReLU3d as JaxDeconv
    from mvster_tpu_torch.nn.blocks import ConvTransposeBnReLU3d

    x = np.random.default_rng(4).normal(size=(2, 3, 5, 6, 16)).astype(np.float32)
    jmod = JaxDeconv(8, stride=(2, 2, 2))
    variables = _variables(jmod, jnp.asarray(x), seed=4)
    port = ConvTransposeBnReLU3d(16, 8, kernel_size=(3, 3, 3), stride=(2, 2, 2))
    port.load_state_dict(_port_state(variables, ("reg_0", "conv7"), "reg.0.conv7."),
                         strict=True)
    with torch.no_grad():
        got = _ndhwc(port.eval()(_ncdhw(x)))
    assert got.shape == (2, 6, 10, 12, 8)
    _close(got, jmod.apply(variables, jnp.asarray(x), False))


def test_exporter_flips_every_axis_of_a_transposed_kernel():
    """The JAX package stores a transposed conv's kernel flipped on all
    three spatial axes (DHWIO); the exporter flips it back to torch's
    (I, O, kd, kh, kw), on the depth axis too."""
    from mvster_tpu_torch.tools.convert import _inv_deconv3d

    k = np.arange(3 * 3 * 3 * 2 * 4, dtype=np.float32).reshape(3, 3, 3, 2, 4)
    w = _inv_deconv3d(k)
    assert w.shape == (2, 4, 3, 3, 3)
    for d, i, j in np.ndindex(3, 3, 3):
        np.testing.assert_array_equal(w[:, :, d, i, j], k[2 - d, 2 - i, 2 - j])


# (down_size, D): D halves at each level, so it must divide by 2 ** down_size
REG3D_CASES = [(1, 4), (2, 4), (1, 8), (2, 8), (3, 8)]


@pytest.mark.parametrize("down_size,depth", REG3D_CASES)
def test_reg3d_matches_jax(down_size, depth):
    from mvster_tpu.nn.reg import Reg3d as JaxReg3d
    from mvster_tpu_torch.nn.reg import Reg3d

    x = np.random.default_rng(down_size).normal(size=(1, depth, 16, 24, 4)).astype(np.float32)
    jmod = JaxReg3d(8, down_size)
    variables = _variables(jmod, jnp.asarray(x), seed=down_size)
    port = Reg3d(4, 8, down_size)
    port.load_state_dict(_port_state(variables, ("reg_0",), "reg.0."), strict=True)
    with torch.no_grad():
        got = port.eval()(_ncdhw(x)).numpy()
    want = jmod.apply(variables, jnp.asarray(x), False)
    assert got.shape == want.shape == (1, depth, 16, 24)
    _close(got, want)


def test_reg3d_train_mode_at_a_1x1x1_deepest_level():
    """Reg3d at down size 3 on a (1, 8, 8, 8) volume: its deepest level is
    1x1x1 with batch 1, where the train-mode norms see one value per
    channel (the repair of _FlaxStats).  Logits and running statistics."""
    from mvster_tpu.nn.reg import Reg3d as JaxReg3d
    from mvster_tpu_torch.nn.reg import Reg3d

    x = np.random.default_rng(7).normal(size=(1, 8, 8, 8, 4)).astype(np.float32)
    jmod = JaxReg3d(8, 3)
    variables = _variables(jmod, jnp.asarray(x), seed=7)
    port = Reg3d(4, 8, 3)
    port.load_state_dict(_port_state(variables, ("reg_0",), "reg.0."), strict=True)
    want, stats = _train_apply(jmod, variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.train()(_ncdhw(x)).numpy()
    _close(got, want)
    _check_running_stats(port, stats, ("reg_0",), "reg.0.")


# ---- positional encodings, ASFF, ConvNeXt, DCN

def test_pos_enc_sine_matches_jax():
    from mvster_tpu.nn.posenc import PosEncSine
    from mvster_tpu_torch.nn.posenc import pos_enc_sine

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 8, 8, 8)).astype(np.float32)
    depth = rng.uniform(425, 935, size=(2, 4, 8, 8)).astype(np.float32)
    xt = t(x).requires_grad_()
    got = pos_enc_sine(xt, t(depth))
    _close(got.detach().numpy(), PosEncSine().apply({}, jnp.asarray(x), jnp.asarray(depth)))
    got.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


def test_pos_enc_learned_matches_jax():
    from mvster_tpu.nn.posenc import PosEncLearned
    from mvster_tpu_torch.nn.posenc import pos_enc_learned

    x = np.random.default_rng(9).normal(size=(2, 4, 8, 8, 8)).astype(np.float32)
    jmod = PosEncLearned(4)
    variables = _variables(jmod, jnp.asarray(x), seed=9)
    embed = _port_state(variables, ("pos_enc_2",), "pos_enc_func.2")[""]
    assert embed.shape == (8, 4)  # the reference's (C, D)
    _close(pos_enc_learned(t(x), embed).numpy(), jmod.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_asff_matches_jax(level):
    from mvster_tpu.nn.fpn import ASFF as JaxASFF
    from mvster_tpu_torch.nn.fpn import ASFF

    rng = np.random.default_rng(10 + level)
    xs = [rng.normal(size=(2, 4 * 2 ** i, 6 * 2 ** i, c)).astype(np.float32)
          for i, c in enumerate((64, 32, 16, 8))]
    jmod = JaxASFF(level)
    variables = _variables(jmod, *map(jnp.asarray, xs), False, seed=level)
    port = ASFF(level)
    port.load_state_dict(_port_state(variables, (f"asff_{level}",), f"asff.{level}."),
                         strict=True)
    with torch.no_grad():
        got = port.eval()(*map(t, xs)).numpy()
    want = jmod.apply(variables, *map(jnp.asarray, xs), False)
    assert got.shape == (2, 4 * 2 ** level, 6 * 2 ** level, (64, 32, 16, 8)[level])
    _close(got, want)


@pytest.mark.parametrize("kind", ["convnext", "convnext4"])
def test_convnext_pyramid_matches_jax(kind):
    """Both ConvNeXt pyramids with the layer scales at 0.5 +- 0.2 (their
    1e-6 init would crush the encoder's output to ~1e-6, and the
    comparison with it)."""
    from mvster_tpu.nn import fpn as jax_fpn
    from mvster_tpu_torch.nn import fpn

    jcls, pcls = {"convnext": (jax_fpn.FPN4ConvNeXt, fpn.FPN4ConvNeXt),
                  "convnext4": (jax_fpn.FPN4ConvNeXt4, fpn.FPN4ConvNeXt4)}[kind]
    rng = np.random.default_rng(12)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jmod = jcls(8)
    variables = _variables(jmod, jnp.asarray(x), False, seed=12)
    for block in ("conv1", "conv2", "conv3"):
        gamma = variables["params"][block]["gamma"]
        variables["params"][block]["gamma"] = rng.normal(0.5, 0.2, gamma.shape).astype(np.float32)
    port = pcls(8)
    port.load_state_dict(_port_state(variables, ("feature",), "feature."), strict=True)
    with torch.no_grad():
        got = port.eval()(t(x).permute(0, 3, 1, 2))
    want = jmod.apply(variables, jnp.asarray(x), False)
    for key in ("stage1", "stage2", "stage3", "stage4"):
        _close(got[key].permute(0, 2, 3, 1).numpy(), want[key], key)


def test_deform_conv_matches_jax():
    """DeformConv2d with He-normal offset and modulation convs (offsets of
    about a pixel: the bilinear taps and the border clamp are exercised)."""
    from mvster_tpu.nn.dcn import DeformConv2d as JaxDCN
    from mvster_tpu_torch.nn.dcn import DeformConv2d

    x = np.random.default_rng(13).normal(size=(2, 12, 14, 8)).astype(np.float32)
    jmod = JaxDCN(8)
    variables = _variables(jmod, jnp.asarray(x), seed=13)
    assert np.abs(variables["params"]["p_conv"]["kernel"]).max() > 0
    port = DeformConv2d(8, 8)
    port.load_state_dict(_port_state(variables, ("feature", "dcn1", "dcn"), "feature.dcn1.2."),
                         strict=True)
    xt = t(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    got = port(xt)
    want = jmod.apply(variables, jnp.asarray(x))
    _close(got.detach().permute(0, 2, 3, 1).numpy(), want)
    got.sum().backward()
    g_x = jax.grad(lambda v: jnp.sum(jmod.apply(variables, v)))(jnp.asarray(x))
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), g_x, "input gradient")
