"""The fused Sinkhorn OT loss (kernels/sinkhorn_ot.py) against the JAX package, and K4/K5 against plain.

CPU, against the JAX package (inputs from numpy seeds), with the JAX
package's own tolerances for its Pallas pair (tests/test_pallas_sinkhorn.py):
  sinkhorn_loss_fused (the plain route) vs sinkhorn_loss_pallas in
  interpret mode: the loss at rtol 1e-5, the attn_weight gradient at rtol
  2e-4 / atol 5e-7; the same through mvs4net_loss and blend_loss with
  ot_backend="pallas" (every aux scalar at rtol 1e-5, each stage's
  attn_weight gradient at rtol 2e-4 / atol 5e-7).
CPU, within the port: the written-out reverse sweep sinkhorn_pixels_bwd_plain
against autograd through sinkhorn_pixels_plain, in float64 at rtol 1e-9
(the same function, so only float64 rounding separates them).
CUDA (marked `cuda`, skipped without a card): K4 vs plain per pixel at rtol 1e-5 /
atol 1e-6; K5 vs plain at rtol 1e-4 with an absolute floor of 1e-4 of the
largest |dL/dpred| (where pred underflows, dL/dpred = dlog_nu / 1e-12
magnifies rounding); the Function's gradient vs autograd through the plain
forward at the same tolerance.
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, t  # noqa: F401
from mvster_tpu_torch.kernels import sinkhorn_ot


def _inputs(seed, b=2, d=8, h=8, w=8, gain=3.0, mask_p=0.3):
    """gt (B, H, W), sorted hypotheses and a softmax attention (B, D, H, W)
    over DTU's depth range, mask (B, H, W) bool: tests/test_pallas_sinkhorn.py's
    recipe, with sharper attention (gain) so some bins are near 0."""
    rng = np.random.default_rng(seed)
    hypo = np.sort(rng.uniform(400, 900, size=(b, d, h, w)), axis=1)
    gt = rng.uniform(420, 880, size=(b, h, w))
    logits = rng.normal(size=(b, d, h, w)) * gain
    attn = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    mask = rng.uniform(size=(b, h, w)) > mask_p
    return [x.astype(np.float32) for x in (gt, hypo, attn)] + [mask]


def _jax_pallas(gt, hypo, attn, mask, iters, eps):
    """sinkhorn_loss_pallas and its attn_weight gradient, interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from mvster_tpu.kernels.pallas_sinkhorn import sinkhorn_loss_pallas

    def fn(a):
        return sinkhorn_loss_pallas(jnp.asarray(gt), jnp.asarray(hypo), a,
                                    jnp.asarray(mask), iters=iters, eps=eps)

    with pltpu.force_tpu_interpret_mode():
        loss, grad = jax.value_and_grad(fn)(jnp.asarray(attn))
    return float(loss), np.asarray(grad)


def _port(gt, hypo, attn, mask, iters, eps):
    a = t(attn).requires_grad_()
    loss = sinkhorn_ot.sinkhorn_loss_fused(t(gt), t(hypo), a, torch.from_numpy(mask),
                                           iters=iters, eps=eps)
    loss.backward()
    return float(loss.detach()), a.grad.numpy()


@pytest.mark.parametrize("d,b,h,w,iters,eps,mask_p", [
    (4, 2, 8, 8, 10, 1.0, 0.3),
    (8, 1, 16, 16, 6, 1.0, 0.3),
    (8, 2, 8, 16, 10, 0.7, 0.3),  # eps != 1: cost = (|i-j| / eps) * eps
    (4, 1, 8, 8, 8, 1.0, 1.1),    # all-zero mask: the mean's denominator clamps to 1
    (2, 2, 8, 8, 10, 1.0, 0.3),   # depth counts off dtu_default's 8, 8, 4, 4
    (3, 1, 8, 16, 10, 1.0, 0.3),
    (16, 1, 8, 8, 10, 1.0, 0.3),
])
def test_fused_loss_matches_pallas_interpret(d, b, h, w, iters, eps, mask_p):
    gt, hypo, attn, mask = _inputs(d + iters, b, d, h, w, mask_p=mask_p)
    want_loss, want_grad = _jax_pallas(gt, hypo, attn, mask, iters, eps)
    got_loss, got_grad = _port(gt, hypo, attn, mask, iters, eps)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(got_grad, want_grad, rtol=2e-4, atol=5e-7)
    if not mask.any():
        assert got_loss == 0.0 and not got_grad.any()


@pytest.mark.parametrize("d,iters,eps", [(4, 10, 1.0), (8, 6, 1.0), (8, 10, 0.5)])
def test_bwd_plain_matches_autograd(d, iters, eps):
    """The written-out reverse sweep is the gradient of the plain forward."""
    _, _, attn, _ = _inputs(20 + d, 2, d, 8, 8)
    rng = np.random.default_rng(21)
    pred = torch.from_numpy(attn.astype(np.float64).reshape(2, d, 64)).requires_grad_()
    gt_idx = torch.from_numpy(rng.integers(0, d, size=(2, 64)))
    g = torch.from_numpy(rng.uniform(0.0, 1.0, size=(2, 64)))
    (sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, iters, eps) * g).sum().backward()
    got = sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred.detach(), gt_idx, g, iters, eps)
    np.testing.assert_allclose(got.numpy(), pred.grad.numpy(), rtol=1e-9, atol=1e-12)


def test_per_pixel_loss_matches_core_sinkhorn():
    """Per pixel, K4's plain version is <T, C> of core.sinkhorn's plan."""
    from mvster_tpu_torch.core.sinkhorn import sinkhorn

    gt, hypo, attn, mask = _inputs(30, 2, 8, 8, 8)
    t_map, _ = sinkhorn(t(gt), t(hypo), t(attn), torch.from_numpy(mask), iters=10)
    cost = (torch.arange(8.0)[:, None] - torch.arange(8.0)[None]).abs()
    want = (t_map * cost).sum(dim=(2, 3))  # (B, HW)
    gt_idx = torch.argmin((t(hypo) - t(gt)[:, None]).abs(), dim=1).reshape(2, 64)
    got = sinkhorn_ot.sinkhorn_pixels_plain(t(attn).reshape(2, 8, 64), gt_idx, 10)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn_name", ["mvs4net_loss", "blend_loss"])
def test_pallas_backend_through_the_losses_matches_jax(fn_name):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from _torch_parity import torch_batch
    from mvster_tpu.models import losses as jax_losses
    from mvster_tpu_torch.models import losses

    from test_torch_losses import _loss_outputs

    outputs, depth, mask, dv = _loss_outputs(5, mono=True)
    kw = dict(inverse_depth=True, mono=True, l1ot_lw=(1.0, 1.0), ot_iter=8,
              ot_backend="pallas")
    stages = [k for k in outputs if k.startswith("stage")]
    jnp_tree = lambda x: jax.tree_util.tree_map(jnp.asarray, x)  # noqa: E731

    def jax_total(attns):
        outs = {k: (dict(v, attn_weight=attns[k]) if k in attns else v)
                for k, v in jnp_tree(outputs).items()}
        total, aux = getattr(jax_losses, fn_name)(
            outs, jnp_tree(depth), jnp_tree(mask), depth_values=jnp.asarray(dv), **kw)
        return total, aux

    with pltpu.force_tpu_interpret_mode():
        (want, want_aux), want_grads = jax.value_and_grad(jax_total, has_aux=True)(
            {k: jnp.asarray(outputs[k]["attn_weight"]) for k in stages})

    port_out = torch_batch({k: v for k, v in outputs.items() if k.startswith("stage")})
    attns = {k: port_out[k]["attn_weight"].requires_grad_() for k in stages}
    port_out.update(port_out["stage4"])
    got, got_aux = getattr(losses, fn_name)(port_out, torch_batch(depth), torch_batch(mask),
                                            depth_values=t(dv), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert got_aux.keys() == want_aux.keys()
    for key, want_v in want_aux.items():
        got_v = got_aux[key] if isinstance(want_v, list) else [got_aux[key]]
        want_v = want_v if isinstance(want_v, list) else [want_v]
        np.testing.assert_allclose([float(x) for x in got_v], [float(x) for x in want_v],
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    for k in stages:
        np.testing.assert_allclose(attns[k].grad.numpy(), np.asarray(want_grads[k]),
                                   rtol=2e-4, atol=5e-7, err_msg=k)


def test_cpu_tensors_take_the_plain_versions():
    gt, hypo, attn, mask = _inputs(40, 1, 4, 8, 8)
    before = (sinkhorn_ot.sinkhorn_fwd.launches, sinkhorn_ot.sinkhorn_bwd.launches)
    pred = t(attn).reshape(1, 4, 64).requires_grad_()
    gt_idx = torch.argmin((t(hypo) - t(gt)[:, None]).abs(), dim=1).reshape(1, 64).int()
    out = sinkhorn_ot.sinkhorn_pixels(pred, gt_idx, 10)
    np.testing.assert_array_equal(
        out.detach().numpy(), sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, 10).detach().numpy())
    out.sum().backward()
    np.testing.assert_array_equal(
        pred.grad.numpy(),
        sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred.detach(), gt_idx, torch.ones(1, 64), 10).numpy())
    assert (sinkhorn_ot.sinkhorn_fwd.launches, sinkhorn_ot.sinkhorn_bwd.launches) == before


@pytest.mark.parametrize("d,want", [
    (1, ("lanes", 1, 1)), (2, ("lanes", 2, 2)), (3, ("lanes", 4, 4)), (4, ("lanes", 4, 4)),
    (5, ("lanes", 8, 8)), (8, ("lanes", 8, 8)), (16, ("lanes", 16, 16)),
    (32, ("lanes", 32, 32)), (33, ("thread", 1, 64)), (64, ("thread", 1, 64)),
])
def test_plan_launch_gives_a_pixel_d_lanes_up_to_32_bins(d, want):
    """L lanes a pixel, L the smallest power of two >= D, up to 32 bins;
    one thread a pixel (capacity 64) above; K4 and K5 alike where the
    pixels do not fill the card (64x80, batch 2)."""
    for kernel in sinkhorn_ot.KERNELS:
        plan = sinkhorn_ot.plan_launch(kernel, d, 10, 2 * 64 * 80)
        assert (plan.design, plan.lanes, plan.capacity) == want
        assert plan.capacity == sinkhorn_ot.capacity(d)
        assert plan.design in sinkhorn_ot.DESIGNS and plan.threads % 32 == 0
    fwd = sinkhorn_ot.plan_launch("fwd", d, 10, 2 * 64 * 80)
    assert (fwd.threads, fwd.smem) == (sinkhorn_ot.THREADS if d <= 32 else 128, 0)


@pytest.mark.parametrize("kernel,d,h,w,want", [
    # dtu_default's stages at 512x640, batch 2: D = 8 at 64x80 and 128x160
    # takes lanes, D = 4 at 256x320 and 512x640 one thread a pixel
    ("fwd", 8, 64, 80, ("lanes", 8)), ("bwd", 8, 128, 160, ("lanes", 8)),
    ("fwd", 4, 256, 320, ("thread", 4)), ("bwd", 4, 512, 640, ("thread", 4)),
    # one thread a pixel where it was faster on a full card: K4 at 3 <= D <= 8
    # (D = 5 from 128x160), K5 at 3 <= D <= 5; lanes elsewhere
    ("fwd", 3, 256, 320, ("thread", 4)), ("fwd", 8, 256, 320, ("thread", 8)),
    ("fwd", 5, 128, 160, ("thread", 8)), ("fwd", 5, 64, 80, ("lanes", 8)),
    ("bwd", 5, 128, 160, ("lanes", 8)),
    ("bwd", 5, 256, 320, ("thread", 8)), ("bwd", 6, 512, 640, ("lanes", 8)),
    ("bwd", 8, 512, 640, ("lanes", 8)), ("fwd", 2, 512, 640, ("lanes", 2)),
    ("fwd", 16, 512, 640, ("lanes", 16)), ("fwd", 4, 128, 160, ("lanes", 4)),
])
def test_plan_launch_takes_one_thread_a_pixel_where_it_was_faster(kernel, d, h, w, want):
    plan = sinkhorn_ot.plan_launch(kernel, d, 10, 2 * h * w)
    assert (plan.design, plan.capacity) == want
    assert plan.capacity in (sinkhorn_ot.LANE_CAPACITIES if plan.design == "lanes"
                             else sinkhorn_ot.THREAD_CAPACITIES)


@pytest.mark.parametrize("d,iters,want", [
    # lanes: 4 (2 iters + L + 1) bytes a thread, the largest block within 48 KB
    (8, 10, (256, 256 * 116)), (4, 10, (256, 256 * 100)), (8, 0, (256, 256 * 36)),
    (32, 10, (128, 128 * 212)), (32, 60, (64, 64 * 612)), (8, 60, (64, 64 * 516)),
    (1, 60, (64, 64 * 488)),
    # thread: 8 iters D bytes a thread
    (33, 0, (256, 0)), (33, 2, (64, 64 * 528)),
])
def test_plan_launch_sizes_k5s_block_and_shared_memory(d, iters, want):
    plan = sinkhorn_ot.plan_launch("bwd", d, iters, 2 * 64 * 80)
    assert (plan.threads, plan.smem) == want
    assert plan.smem <= 48 * 1024


def test_plan_launch_sizes_k5s_history_with_one_thread_a_pixel():
    """(iters, 2, D) floats a thread: 128 threads at D = 4 and 10
    iterations (40 KB), 64 at D = 5."""
    full = 2 * 512 * 640
    assert sinkhorn_ot.plan_launch("bwd", 4, 10, full)[3:] == (128, 128 * 320)
    assert sinkhorn_ot.plan_launch("bwd", 5, 10, full)[3:] == (64, 64 * 400)
    assert sinkhorn_ot.plan_launch("fwd", 4, 10, full)[3:] == (sinkhorn_ot.THREAD_FWD, 0)


@pytest.mark.parametrize("d,iters", [(8, 200), (64, 10), (33, 10)])
def test_plan_launch_raises_the_limit_above_48_kb(d, iters):
    """Where 32 threads need more than 48 KB, the launch raises the block's
    limit (up to 227 KB)."""
    plan = sinkhorn_ot.plan_launch("bwd", d, iters, 2 * 64 * 80)
    assert plan.threads == 32 and 48 * 1024 < plan.smem <= sinkhorn_ot.SMEM_BYTES_MAX


@pytest.mark.parametrize("d,iters", [(8, 904), (64, 15)])
def test_plan_launch_rejects_what_does_not_fit_in_227_kb(d, iters):
    with pytest.raises(ValueError, match="shared memory"):
        sinkhorn_ot.plan_launch("bwd", d, iters, 2 * 64 * 80)
    assert sinkhorn_ot.plan_launch("bwd", d, iters - 1, 2 * 64 * 80).smem <= \
        sinkhorn_ot.SMEM_BYTES_MAX


def test_plan_launch_rejects_an_unknown_kernel():
    with pytest.raises(ValueError, match="kernel must be one of"):
        sinkhorn_ot.plan_launch("both", 8, 10, 100)


@pytest.mark.parametrize("d", [0, 65])
def test_capacity_rejects_d_outside_the_kernels(d):
    with pytest.raises(ValueError, match="1 <= D <= 64"):
        sinkhorn_ot.capacity(d)


# (H, W, D) of each dtu_default stage at 512x640, batch 2
CARD_SHAPES = [(64, 80, 8), (128, 160, 8), (256, 320, 4), (512, 640, 4)]


def _card_inputs(shape, device, seed=7, b=2):
    h, w, d = shape
    gt, hypo, attn, mask = _inputs(seed, b, d, h, w)
    pred = t(attn, device).reshape(b, d, h * w)
    gt_idx = torch.argmin((t(hypo, device) - t(gt, device)[:, None]).abs(),
                          dim=1).reshape(b, h * w).int()
    m = torch.from_numpy(mask).to(device).reshape(b, h * w).float()
    return pred, gt_idx, m / m.sum().clamp(min=1.0)


def _assert_dpred_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda_device, shape):
    pred, gt_idx, g = _card_inputs(shape, cuda_device)
    before = (sinkhorn_ot.sinkhorn_fwd.launches, sinkhorn_ot.sinkhorn_bwd.launches)
    loss = sinkhorn_ot.sinkhorn_fwd(pred, gt_idx, 10)
    dpred = sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g, 10)
    torch.cuda.synchronize()
    assert (sinkhorn_ot.sinkhorn_fwd.launches,
            sinkhorn_ot.sinkhorn_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(loss, sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, 10),
                               rtol=1e-5, atol=1e-6)
    _assert_dpred_close(dpred, sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred, gt_idx, g, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("d,iters,eps", [(8, 60, 1.0), (4, 3, 0.7), (8, 60, 0.7),
                                         (8, 0, 1.0), (8, 200, 1.0), (64, 10, 1.0)])
def test_kernels_match_plain_at_other_iters_and_eps_on_card(cuda_device, d, iters, eps):
    """iters 0 (no history, dL/dpred = 0), and above 48 KB of K5's shared
    memory at 32 threads (iters 200 at D = 8, D = 64): the launch raises
    the block's limit."""
    pred, gt_idx, g = _card_inputs((32, 48, d), cuda_device)
    torch.testing.assert_close(sinkhorn_ot.sinkhorn_fwd(pred, gt_idx, iters, eps),
                               sinkhorn_ot.sinkhorn_pixels_plain(pred, gt_idx, iters, eps),
                               rtol=1e-5, atol=1e-6)
    _assert_dpred_close(sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g, iters, eps),
                        sinkhorn_ot.sinkhorn_pixels_bwd_plain(pred, gt_idx, g, iters, eps))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 5, 16, 31, 32, 33, 64])
def test_kernels_take_other_d_on_card(cuda_device, d):
    """Depth counts off dtu_default: every lanes capacity, D below its
    capacity (3, 5, 31), and one thread a pixel above 32 bins."""
    test_kernels_match_plain_on_card(cuda_device, (32, 48, d))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 4, 5, 32, 33, 1, 2, 3, 16, 31, 64])
def test_kernels_take_a_ragged_shape_on_card(cuda_device, d):
    """B * N = 2 * 31 * 37 is no multiple of a block's pixels: the tail
    block's idle lanes still reach every shuffle."""
    assert (2 * 31 * 37) % (sinkhorn_ot.THREADS // sinkhorn_ot.capacity(d))
    test_kernels_match_plain_on_card(cuda_device, (31, 37, d))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 5, 6, 8])
def test_kernels_take_one_thread_a_pixel_on_a_full_card(cuda_device, d):
    """256x320 at batch 2 fills the card: one thread a pixel for K4 (and
    for K5 at D = 3, 5), the instances below capacity at D = 3, 5, 6."""
    assert sinkhorn_ot.plan_launch("fwd", d, 10, 2 * 256 * 320).design == "thread"
    test_kernels_match_plain_on_card(cuda_device, (256, 320, d))


@pytest.mark.cuda
def test_function_grad_matches_plain_autograd_on_card(cuda_device):
    gt, hypo, attn, mask = _inputs(8, 2, 8, 128, 160)
    args = [t(x, cuda_device) for x in (gt, hypo)]
    m = torch.from_numpy(mask).to(cuda_device)
    a = t(attn, cuda_device).requires_grad_()
    b = t(attn, cuda_device).requires_grad_()
    got = sinkhorn_ot.sinkhorn_loss_fused(*args, a, m, iters=10)
    got.backward()
    from mvster_tpu_torch.core.sinkhorn import sinkhorn

    want = sinkhorn(*args, b, m, iters=10)[1]
    want.backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    _assert_dpred_close(a.grad, b.grad)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    pred, gt_idx, g = _card_inputs((16, 16, 4), cuda_device)
    with pytest.raises(ValueError, match="1 <= D <= 64"):
        sinkhorn_ot.sinkhorn_fwd(pred.repeat(1, 17, 1)[:, :65].contiguous(), gt_idx, 10)
    with pytest.raises(ValueError, match="float32"):
        sinkhorn_ot.sinkhorn_fwd(pred.double(), gt_idx, 10)
    with pytest.raises(ValueError, match="int32"):
        sinkhorn_ot.sinkhorn_fwd(pred, gt_idx.long(), 10)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g.t().contiguous().t(), 10)
    with pytest.raises(ValueError, match="is on"):
        sinkhorn_ot.sinkhorn_bwd(pred, gt_idx, g.cpu(), 10)
