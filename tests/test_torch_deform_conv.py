"""The DCN heads' sampling and contraction (kernels/deform_conv.py) and its dispatch, on the CPU.

The plain version against the JAX package's DeformConv2d (mvster_tpu.nn.dcn)
with the same offsets and modulation logits handed to its p_conv and m_conv
(flax interceptors), at each head's channel count and with offsets of about
a pixel and of many (past the padded border, so the clamp acts); the port's
DeformConv2d against the JAX module on the same weights, its offset conv
scaled to reach past the border; a band of rows (row0 > 0 over a taller
whole map) against the matching rows of the whole map's output.  Tolerance
as tests/test_torch_variants.py: rtol 1e-5, atol 1e-5 of the largest
magnitude (float32 sums of up to 576 products in another order).

The dispatch: CPU tensors take the plain version, with autograd on or off;
any other call goes to K7 (an autograd Function whose backward recomputes
the plain version's gradients, checked here with the plain version standing
in for the launch), which refuses, naming the reason, a dtype or shape it
has no instance for (meta tensors stand in for the card: the checks come
before any launch).  K7 itself is tested on the card in
tests/test_torch_deform_conv_cuda.py.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import perturbed_variables, t
from mvster_tpu.nn.dcn import DeformConv2d as JaxDCN
from mvster_tpu_torch.kernels import deform_conv as dc
from mvster_tpu_torch.nn.dcn import DeformConv2d
from mvster_tpu_torch.tools.convert import export_state_dict

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def _inputs(c, h, w, reach, seed, b=2, bands=1):
    """A whole map of bands * h rows (after ReLU), offsets of `reach` pixels
    (normal), mask logits and a weight scaled to unit outputs."""
    gen = torch.Generator().manual_seed(seed)
    whole = torch.randn(b, c, bands * h, w, generator=gen).relu()
    offsets = torch.randn(b, 18, h, w, generator=gen) * reach
    mask = torch.randn(b, 9, h, w, generator=gen) * 2.0
    weight = torch.randn(c, c, 3, 3, generator=gen) / (9 * c) ** 0.5
    return [whole, offsets, mask, weight]


def _nhwc(x):
    return jnp.asarray(x.detach().permute(0, 2, 3, 1).numpy())


def _jax_deform_conv(x, offsets, mask, weight):
    """JAX's DeformConv2d with p_conv's and m_conv's outputs replaced by
    `offsets` and `mask` and its (n, C, O) kernel taken from `weight`."""
    c = weight.shape[1]
    jmod = JaxDCN(weight.shape[0])
    variables = jmod.init(jax.random.PRNGKey(0), _nhwc(x))
    kernel = weight.reshape(weight.shape[0], c, 9).permute(2, 1, 0)  # (n, C, O)
    variables = {**variables, "params": {**variables["params"],
                                         "kernel": jnp.asarray(kernel.numpy())}}
    given = {"p_conv": _nhwc(offsets), "m_conv": _nhwc(mask)}

    def intercept(call, args, kwargs, context):
        if context.method_name == "__call__" and context.module.name in given:
            return given[context.module.name]
        return call(*args, **kwargs)

    with nn.intercept_methods(intercept):
        return jmod.apply(variables, _nhwc(x))


@pytest.mark.parametrize("reach", [1.0, 9.0], ids=["1px", "9px"])
@pytest.mark.parametrize("c", [64, 32, 16, 8])
def test_plain_matches_jax(c, reach):
    x, offsets, mask, weight = _inputs(c, 7, 11, reach, seed=c + int(reach))
    got = dc.deform_conv_plain(x, offsets, mask, weight)
    _close(got.permute(0, 2, 3, 1).numpy(), _jax_deform_conv(x, offsets, mask, weight))
    if reach > 1:  # some taps left the padded map and were clamped to its border
        py = torch.arange(7.0)[:, None, None] + offsets.permute(0, 2, 3, 1)[..., :9]
        assert (py < -1).any() and (py > 7).any()


@pytest.mark.parametrize("c", [64, 32, 16, 8])
def test_module_matches_jax(c):
    """The port's DeformConv2d (its two convs and the sampling) on JAX's
    weights, the offset conv scaled to offsets of ~9 px."""
    x = np.random.default_rng(c).normal(size=(2, 9, 13, c)).astype(np.float32)
    jmod = JaxDCN(c)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = perturbed_variables(shapes, seed=c)
    variables["params"]["p_conv"]["kernel"] = variables["params"]["p_conv"]["kernel"] * 6.0
    nested = {k: {"feature": {"dcn1": {"dcn": v}}} for k, v in variables.items() if v}
    prefix = "feature.dcn1.2."
    port = DeformConv2d(c, c)
    port.load_state_dict({k[len(prefix):]: torch.from_numpy(np.array(v))
                          for k, v in export_state_dict(nested).items()}, strict=True)
    xt = t(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = port(xt)
        reach = port.p_conv(xt).abs().max()
    assert reach > 9  # taps past the padded border
    _close(got.permute(0, 2, 3, 1).numpy(), jmod.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("row0", [0, 6, 12])
def test_plain_on_a_band_is_the_whole_maps_rows(row0):
    """A band's output is the whole map's output at the band's rows: the
    taps sample the whole map at global rows (4 px offsets reach other
    bands).  Held at rtol = atol = 1e-6: one GEMM over other rows may
    block its sums otherwise."""
    whole, offsets, mask, weight = _inputs(16, 18, 9, 4.0, seed=30 + row0)
    want = dc.deform_conv_plain(whole, offsets, mask, weight)[:, :, row0:row0 + 6]
    band = slice(row0, row0 + 6)
    got = dc.deform_conv_plain(whole, offsets[:, :, band], mask[:, :, band], weight, row0)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_cpu_takes_the_plain_version():
    whole, offsets, mask, weight = _inputs(8, 5, 6, 2.0, seed=4)
    before = dc.deform_conv.launches
    with torch.no_grad():
        got = dc.deform_conv(whole, offsets, mask, weight)
    assert dc.deform_conv.launches == before
    assert torch.equal(got, dc.deform_conv_plain(whole, offsets, mask, weight))


def test_under_autograd_only_the_cpu_takes_the_plain_version():
    whole, offsets, mask, weight = _inputs(8, 5, 6, 2.0, seed=5)
    weight.requires_grad_(True)
    out = dc.deform_conv(whole, offsets, mask, weight)
    out.sum().backward()
    assert weight.grad is not None and weight.grad.abs().sum() > 0
    # not on the CPU: with autograd on, the call goes to K7 all the same
    meta = [x.to("meta") for x in (whole, offsets, mask, weight.detach())]
    meta[3].requires_grad_(True)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dc.deform_conv(*meta)


@pytest.mark.parametrize("wrt", [(0, 1, 2, 3), (3,), (0, 1)], ids=["all", "weight", "x_offsets"])
def test_k7s_backward_is_the_plain_versions_gradients(monkeypatch, wrt):
    """_K7's backward, with the plain version standing in for the launch
    (no card here): the plain version's own autograd gradients, bit for
    bit, for the inputs that want one and None for the others."""
    monkeypatch.setattr(dc, "_launch", dc.deform_conv_plain)
    inputs = _inputs(16, 6, 7, 3.0, seed=80, bands=2)
    a = [x.clone().requires_grad_(i in wrt) for i, x in enumerate(inputs)]
    b = [x.clone().requires_grad_(i in wrt) for i, x in enumerate(inputs)]
    grad = torch.randn(2, 16, 6, 7, generator=torch.Generator().manual_seed(81))
    dc._K7.apply(*a, 4).backward(grad)
    dc.deform_conv_plain(*b, 4).backward(grad)
    for i, (x, y) in enumerate(zip(a, b)):
        if i in wrt:
            assert torch.equal(x.grad, y.grad), i
        else:
            assert x.grad is None


@pytest.mark.parametrize("case,match", [
    ("bf16", "float32 instances only"),
    ("channels", r"O = C in \(8, 16, 32, 64\)"),
    ("o_ne_c", r"O = C in"),
    ("kernel5", r"3x3 kernel"),
    ("offsets", r"offsets .* must be"),
    ("band", "does not lie in a map"),
    ("device", "no kernel for device meta"),
])
def test_k7_refuses_what_it_has_no_instance_for(case, match):
    c = 12 if case == "channels" else 8
    whole, offsets, mask, weight = _inputs(c, 5, 6, 1.0, seed=6, bands=2)
    if case == "bf16":
        whole = whole.bfloat16()
    if case == "o_ne_c":
        weight = weight[:4]
    if case == "kernel5":
        weight = torch.zeros(8, 8, 5, 5)
    if case == "offsets":
        offsets = offsets[:, :9]
    row0 = 6 if case == "band" else 5
    args = [x.to("meta") for x in (whole, offsets, mask, weight)]
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        dc.deform_conv(*args, row0)


def test_bf16_compute_hands_the_heads_float32():
    """Under compute_dtype bfloat16 FPN4 emits bf16 heads, but each DCN
    block's BatchNorm casts to its float32 parameters: K7 sees float32."""
    from mvster_tpu_torch.nn.fpn import FPN4

    fpn = FPN4(8, dcn=True, dtype=torch.bfloat16).eval()
    seen = []
    for i in range(1, 5):
        getattr(fpn, f"dcn{i}")[2].register_forward_pre_hook(
            lambda m, args: seen.append(args[0].dtype))
    with torch.no_grad():
        out = fpn(torch.rand(1, 3, 64, 64))
    assert seen == [torch.float32] * 4
    assert all(v.dtype == torch.float32 for v in out.values())
