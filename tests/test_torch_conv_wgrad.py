"""K6, the planar convolutions' weight gradient (kernels/conv_wgrad.py), and its dispatch.

CPU: the plain version against autograd's weight gradient of F.conv3d and
F.conv_transpose3d at Reg2d's seven planar cases (conv0 after 4 and 8
groups, the stride-2 convs, the stride-2 transposed convs with output
padding, a band's convs that pad no rows), D > 1, batch 2, odd H and W,
its partial sums grouped into one block and into several as the kernel
groups them (atol 1e-5 in float32, 1e-12 in float64); PlanarConv on CPU
tensors against the modules without it; the rule (blocks.planar_f32,
blocks.takes_k6) against Reg2d, Reg3d, bf16 and FPN4.
CUDA (marked `cuda`, skipped without a card; `chip_smoke.py k6` repeats
them at the train cells' shapes): K6 against the plain version, the same
bits twice, and PlanarConv's output and gradients against autograd's on
the card.
The file imports no JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_conv_wgrad.py`.
"""

import pytest
import torch
import torch.nn.functional as F

from _torch_parity import cuda_device  # noqa: F401
from mvster_tpu_torch.kernels import conv_wgrad
from mvster_tpu_torch.nn import blocks
from mvster_tpu_torch.nn.fpn import FPN4
from mvster_tpu_torch.nn.reg import Reg2d, Reg3d

# (name, transposed, M, C, stride, padding (H, W), output padding (H, W),
#  the conv input's (H, W)); M, C as K6 takes them (a transposed conv's in, out)
CASES = [
    ("conv0_g4", False, 8, 4, 1, (1, 1), (0, 0), (7, 9)),
    ("conv0_g8", False, 8, 8, 1, (1, 1), (0, 0), (5, 11)),
    ("conv1", False, 16, 8, 2, (1, 1), (0, 0), (9, 7)),
    ("conv3", False, 32, 16, 2, (1, 1), (0, 0), (6, 10)),
    ("conv5", False, 64, 32, 2, (1, 1), (0, 0), (5, 5)),
    ("conv7", True, 64, 32, 2, (1, 1), (1, 1), (3, 5)),
    ("conv9", True, 32, 16, 2, (1, 1), (1, 1), (4, 3)),
    ("conv11", True, 16, 8, 2, (1, 1), (1, 1), (5, 4)),
    ("band_conv0", False, 8, 4, 1, (0, 1), (0, 0), (8, 7)),
    ("band_conv1", False, 16, 8, 2, (0, 1), (0, 0), (9, 6)),
    ("band_conv11", True, 16, 8, 2, (1, 1), (0, 1), (5, 3)),
]
B, D = 2, 3


def _conv(case, x, w):
    _, transposed, _, _, s, pad, opad, _ = case
    if transposed:
        return F.conv_transpose3d(x, w, None, (1, s, s), (0, *pad), (0, *opad))
    return F.conv3d(x, w, None, (1, s, s), (0, *pad))


def _inputs(case, dtype, device="cpu", seed=0):
    _, transposed, m, c, _, _, _, (h, w) = case
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, m if transposed else c, D, h, w, generator=gen, dtype=dtype)
    wt = torch.randn(m, c, 1, 3, 3, generator=gen, dtype=dtype)
    gy = torch.randn(_conv(case, x, wt).shape, generator=gen, dtype=dtype)
    return x.to(device), wt.to(device), gy.to(device)


def _k6_args(case, x, gy):
    """K6's (g, x) for the conv's input x and output gradient gy."""
    transposed, s, pad = case[1], case[4], case[5]
    return ((x, gy) if transposed else (gy, x)), s, pad


@pytest.mark.parametrize("blocks", [1, 7])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_autograd(case, dtype, atol, blocks):
    x, w, gy = _inputs(case, dtype)
    w.requires_grad_(True)
    (want,) = torch.autograd.grad(_conv(case, x, w), w, gy)
    (g, big), s, pad = _k6_args(case, x, gy)
    got = conv_wgrad.conv_wgrad_plain(g, big, s, pad, blocks=blocks)
    torch.testing.assert_close(got, want, atol=atol, rtol=1.3e-6 if dtype == torch.float32 else 1e-7)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5], CASES[10]],
                         ids=lambda c: c[0])
def test_planar_conv_function_matches_autograd(case):
    """PlanarConv on CPU tensors: the forward the same bits, the input
    gradient autograd's, the weight gradient the plain version's."""
    x, w, gy = _inputs(case, torch.float64)
    _, transposed, _, _, s, pad, opad, _ = case
    x.requires_grad_(True)
    w.requires_grad_(True)
    want_y = _conv(case, x, w)
    want = torch.autograd.grad(want_y, (x, w), gy)
    got_y = blocks.PlanarConv.apply(x, w, (1, s, s), (0, *pad), (0, *opad), transposed)
    got = torch.autograd.grad(got_y, (x, w), gy)
    assert torch.equal(got_y, want_y)
    torch.testing.assert_close(got[0], want[0], atol=1e-12, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-12, rtol=1e-12)


PLANAR = {"conv0.conv", "conv1.conv", "conv3.conv", "conv5.conv", "conv7.0", "conv9.0",
          "conv11.0"}


def _accepted(module):
    return {name for name, m in module.named_modules() if blocks.planar_f32(m)}


@pytest.mark.parametrize("agg", ["ConvBnReLU3D", "ConvBnReLU3D_CAM", "ConvBnReLU3D_DCAM",
                                 "ConvBnReLU3D_PAM", "ConvBnReLU3D_PDAM"])
@pytest.mark.parametrize("groups", [4, 8])
def test_rule_takes_exactly_reg2d_planar_blocks(agg, groups):
    assert _accepted(Reg2d(groups, 8, agg)) == PLANAR
    assert _accepted(Reg2d(groups, 8, agg, dtype=torch.float32)) == PLANAR


def test_rule_refuses_the_other_convs():
    assert _accepted(Reg2d(8, 8, dtype=torch.bfloat16)) == set()
    assert _accepted(Reg3d(8, 8)) == set()
    assert _accepted(FPN4(8)) == set()
    reg = Reg2d(4, 8)
    assert all(not blocks.planar_f32(reg.get_submodule(n).conv)
               for n in ("conv2", "conv4", "conv6"))  # the 3x3x3 aggregation blocks
    # the rule's run-time half: never on CPU tensors, nor without autograd
    conv = reg.conv0.conv
    x = torch.zeros(1, 4, 2, 8, 8)
    assert not blocks.takes_k6(conv, x)
    with torch.no_grad():
        assert not blocks.takes_k6(conv, x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_k6_matches_plain_on_the_card(cuda_device, case):
    x, w, gy = _inputs(case, torch.float32, cuda_device, seed=5)
    (g, big), s, pad = _k6_args(case, x, gy)
    before = conv_wgrad.conv_wgrad.launches
    got = conv_wgrad.conv_wgrad(g, big, s, pad)
    again = conv_wgrad.conv_wgrad(g, big, s, pad)
    torch.cuda.synchronize()
    assert conv_wgrad.conv_wgrad.launches == before + 2
    assert torch.equal(got, again)
    nb = conv_wgrad.plan_blocks(tuple(g.shape), big.shape[1], s, cuda_device)
    want = conv_wgrad.conv_wgrad_plain(g, big, s, pad, blocks=nb)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # a non-contiguous g: the kernel reads strides as they come
    g2 = g.transpose(3, 4).contiguous().transpose(3, 4)
    torch.testing.assert_close(conv_wgrad.conv_wgrad(g2, big, s, pad), got, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[5], CASES[10]],
                         ids=lambda c: c[0])
def test_planar_conv_on_the_card_matches_autograd(cuda_device, case):
    x, w, gy = _inputs(case, torch.float32, cuda_device, seed=6)
    _, transposed, _, _, s, pad, opad, _ = case
    x.requires_grad_(True)
    w.requires_grad_(True)
    want_y = _conv(case, x, w)
    want = torch.autograd.grad(want_y, (x, w), gy)
    got_y = blocks.PlanarConv.apply(x, w, (1, s, s), (0, *pad), (0, *opad), transposed)
    got = torch.autograd.grad(got_y, (x, w), gy)
    # the same cuDNN calls, but cuDNN's transposed conv (a dgrad kernel) does
    # not give the same bits from call to call: held to float32 rounding
    torch.testing.assert_close(got_y, want_y, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)
