"""K7, the DCN heads' sampling and contraction, on the card (marked `cuda`; skipped without one).

K7 against the plain version (kernels/deform_conv.deform_conv_plain) at
the four heads' channel counts (64, 32, 16, 8), on odd sizes whose pixel
count leaves a ragged last tile; with offsets of many pixels that reach
past the padded border (the clamp); on a band (row0 > 0 over a taller
whole map) against the plain band path; the same bits from two launches;
a DeformConvBlock under inference mode against the same block on the CPU;
under autograd, K7's forward (also with autograd on and no input that
wants a gradient) and its backward against the plain version's own
gradients on the card; the refusals.

Tolerance: atol = rtol = 1e-5.  K7 sums each output's 9C products in
float32 in its own order (taps, then channels, the modulation folded into
the bilinear weights), the plain version in a GEMM's order, so the two
differ by float32 rounding of sums of unit magnitude over up to 576 terms
(a few 1e-7); nothing else differs: both read the same corners with the
same weights.  The file imports no JAX: `python -m pytest --noconftest
-m cuda tests/test_torch_deform_conv_cuda.py`.
"""

import copy

import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401
from mvster_tpu_torch.kernels import deform_conv as dc
from mvster_tpu_torch.nn.dcn import DeformConvBlock

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(c, h, w, reach, seed, b=3, bands=1, device="cuda"):
    gen = torch.Generator().manual_seed(seed)
    whole = torch.randn(b, c, bands * h, w, generator=gen).relu()
    offsets = torch.randn(b, 18, h, w, generator=gen) * reach
    mask = torch.randn(b, 9, h, w, generator=gen) * 2.0
    weight = torch.randn(c, c, 3, 3, generator=gen) / (9 * c) ** 0.5
    return [t.to(device) for t in (whole, offsets, mask, weight)]


def _k7(*args):
    before = dc.deform_conv.launches
    with torch.inference_mode():
        out = dc.deform_conv(*args)
        again = dc.deform_conv(*args)
    torch.cuda.synchronize()
    assert dc.deform_conv.launches == before + 2
    assert torch.equal(out, again), "K7 gave other bits on a second launch"
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("reach", [1.0, 12.0], ids=["1px", "12px"])
@pytest.mark.parametrize("c", [64, 32, 16, 8])
def test_k7_matches_plain(cuda_device, c, reach):
    # 3 x 37 x 53 = 5883 pixels: the last of 12 tiles of 512 is ragged
    whole, offsets, mask, weight = _inputs(c, 37, 53, reach, seed=c + int(reach))
    got = _k7(whole, offsets, mask, weight)
    want = dc.deform_conv_plain(whole, offsets, mask, weight)
    torch.testing.assert_close(got, want, **TOL)
    if reach > 1:  # taps past the padded border, clamped
        assert offsets.abs().max() > 40


@pytest.mark.cuda
@pytest.mark.parametrize("row0", [0, 19, 38])
def test_k7_on_a_band_matches_plain(cuda_device, row0):
    whole, offsets, mask, weight = _inputs(16, 19, 41, 6.0, seed=60 + row0, bands=3)
    got = _k7(whole, offsets, mask, weight, row0)
    want = dc.deform_conv_plain(whole, offsets, mask, weight, row0)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_block_on_the_card_matches_the_cpu(cuda_device):
    torch.manual_seed(7)
    block = DeformConvBlock(32).eval()
    with torch.no_grad():
        block[0].running_mean.normal_()
        block[0].running_var.uniform_(0.5, 2.0)
        torch.nn.init.normal_(block[2].weight, std=(1 / 288) ** 0.5)
        block[2].p_conv.weight.mul_(6.0)
    card = copy.deepcopy(block).to(cuda_device)
    x = torch.randn(2, 32, 33, 47)
    before = dc.deform_conv.launches
    with torch.inference_mode():
        got = card(x.to(cuda_device)).cpu()
        want = block(x)
    assert dc.deform_conv.launches == before + 1
    # cuDNN's offset convs round otherwise than the CPU's: a tap moves by
    # float32 rounding of its offset, so held a little looser than TOL
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 8])
def test_under_autograd_k7_runs_and_its_gradients_are_the_plain_versions(cuda_device, c):
    # a band, so the map's gradient reaches rows outside it too
    inputs = _inputs(c, 11, 13, 4.0, seed=70 + c, bands=2)
    before = dc.deform_conv.launches
    dc.deform_conv(*inputs, 5)  # autograd on, nothing wants a gradient
    assert dc.deform_conv.launches == before + 1
    a = [x.clone().requires_grad_() for x in inputs]
    b = [x.clone().requires_grad_() for x in inputs]
    out = dc.deform_conv(*a, 5)
    want = dc.deform_conv_plain(*b, 5)
    assert dc.deform_conv.launches == before + 2
    torch.testing.assert_close(out, want, **TOL)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(c)).to(cuda_device)
    out.backward(grad)
    want.backward(grad)
    assert dc.deform_conv.launches == before + 2  # the backward launches no K7
    # the same arithmetic on the same inputs: the plain version's gradients
    # up to the order in which its gather's backward adds
    for name, x, y in zip(("x", "offsets", "mask", "weight"), a, b):
        scale = max(1.0, y.grad.abs().max().item())
        torch.testing.assert_close(x.grad, y.grad, atol=TOL["atol"] * scale, rtol=TOL["rtol"],
                                   msg=name)


@pytest.mark.cuda
def test_k7_refuses_on_the_card(cuda_device):
    whole, offsets, mask, weight = _inputs(8, 9, 10, 1.0, seed=71)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="float32 instances only"):
            dc.deform_conv(whole.bfloat16(), offsets, mask, weight)
        with pytest.raises(ValueError, match="O = C in"):
            dc.deform_conv(whole[:, :4], offsets, mask, weight[:4, :4])
        with pytest.raises(ValueError, match="contiguous"):
            dc.deform_conv(whole, offsets.transpose(2, 3).contiguous().transpose(2, 3),
                           mask, weight)
