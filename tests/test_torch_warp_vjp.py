"""The training warp (kernels/warp_vjp.py) against the JAX package, and K2/K3 against plain.

CPU, against the JAX package (inputs from numpy seeds):
  warp_plain vs JAX grid_sample_zeros (atol 1e-6: the same taps in the same
  order) and vs the Pallas warp-only kernel in interpret mode (atol 1e-5);
  scatter_grad_plain vs the JAX XLA VJP (rtol 1e-5) and vs the Pallas
  scatter kernel in interpret mode (rtol 1e-4, atol 1e-5: both sum the
  taps in their own order); the autograd Function's src gradient vs
  jax.grad through grid_sample_zeros_vjp's interpret-mode Pallas pair (rtol
  1e-4, atol 1e-5).
CPU, the launch planner: at every DTU-mid and 576x768 stage shape and at
C % 4 != 0, the plan's lanes and samples per lane hold the kernels'
assumptions, and the kernels' thread-to-sample mapping (csrc/
warp_scatter.cu, modelled in numpy) covers every (sample, vector) exactly
once.
CUDA (marked `cuda`, skipped without a card): K2 vs warp_plain at atol
1e-6, K3 vs scatter_grad_plain at rtol 1e-4 / atol 1e-5 (atomics sum in no
fixed order), on plane-sweep coordinates at the DTU-mid, 576x768 and
served 832x1152 stages, on a band's coordinates into whole sources (K2
bitwise there), on coordinates spread over and beyond the whole image,
and on coordinates that all land on one 2x2 patch; and the Function's
src.grad vs autograd through warp_plain.
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, stage_inputs, t  # noqa: F401
from mvster_tpu_torch.kernels import warp_vjp


def _coords(d, h, w, slope=0.06):
    """The coordinate pattern of tests/test_pallas_scatter.py: shears and
    shifts that leave the image on every side."""
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = np.stack([gx * 1.03 + 2.0 * k - 3 for k in range(d)])[None]
    y = np.stack([gy * 0.96 + 0.7 * k + gx * slope - 2 for k in range(d)])[None]
    return x.astype(np.float32), y.astype(np.float32)


def _plane_sweep_xy(inp, view=0):
    """Plane-sweep coordinates of one source view for stage_inputs(...)."""
    from mvster_tpu_torch.core.geometry import plane_sweep_coords

    x, y = plane_sweep_coords(t(inp["src_projs"][view]), t(inp["ref_proj"]),
                              t(inp["hypo"]))
    return x.numpy(), y.numpy()


def _jax_sample(src, x, y):
    import jax.numpy as jnp

    from mvster_tpu.core.sampling import grid_sample_zeros

    return np.asarray(grid_sample_zeros(jnp.asarray(src), jnp.asarray(x),
                                        jnp.asarray(y)))


@pytest.mark.parametrize("c", [3, 8, 16])
def test_warp_plain_matches_jax(c):
    inp = stage_inputs(0, 32, 48, c, 4, nsrc=1, batch=2)
    x, y = _plane_sweep_xy(inp)
    src = inp["src"][0]
    got = warp_vjp.warp_plain(t(src), t(x), t(y)).numpy()
    np.testing.assert_allclose(got, _jax_sample(src, x, y), rtol=0, atol=1e-6)


def test_warp_plain_matches_pallas_interpret():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from mvster_tpu.kernels.pallas_warp import warp_pallas

    rng = np.random.default_rng(1)
    x, y = _coords(4, 64, 64)
    src = rng.normal(size=(1, 64, 64, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(warp_pallas(jnp.asarray(src), jnp.asarray(x),
                                      jnp.asarray(y)))
    got = warp_vjp.warp_plain(t(src), t(x), t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _jax_xla_vjp(cot, x, y, src_shape):
    import jax
    import jax.numpy as jnp

    from mvster_tpu.core.sampling import grid_sample_zeros

    _, vjp = jax.vjp(lambda s: grid_sample_zeros(s, jnp.asarray(x), jnp.asarray(y)),
                     jnp.zeros(src_shape, jnp.float32))
    return np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("c", [3, 8, 32])
def test_scatter_grad_plain_matches_jax_vjp(c):
    rng = np.random.default_rng(2)
    inp = stage_inputs(2, 32, 48, c, 4, nsrc=1, batch=2)
    x, y = _plane_sweep_xy(inp)
    cot = rng.normal(size=x.shape + (c,)).astype(np.float32)
    src_shape = (2, 32, 48, c)
    got = warp_vjp.scatter_grad_plain(t(cot), t(x), t(y), src_shape).numpy()
    np.testing.assert_allclose(got, _jax_xla_vjp(cot, x, y, src_shape),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c", [3, 8])
def test_scatter_grad_plain_matches_pallas_interpret(c):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from mvster_tpu.kernels.pallas_scatter import scatter_grad_pallas

    rng = np.random.default_rng(3)
    x, y = _coords(4, 64, 64)
    cot = rng.normal(size=x.shape + (c,)).astype(np.float32)
    src_shape = (1, 64, 64, c)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_grad_pallas(jnp.asarray(cot), jnp.asarray(x),
                                              jnp.asarray(y), src_shape))
    got = warp_vjp.scatter_grad_plain(t(cot), t(x), t(y), src_shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_function_grad_matches_jax_vjp():
    """Against jax.grad through grid_sample_zeros_vjp with its Pallas K2/K3
    pair in interpret mode, as tests/test_pallas_scatter.py runs it: the
    TPU scatter sums in its own order, hence rtol 1e-4 / atol 1e-5."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from mvster_tpu.kernels.pallas_scatter import grid_sample_zeros_vjp

    rng = np.random.default_rng(4)
    x, y = _coords(2, 32, 64)
    src = rng.normal(size=(1, 32, 64, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(
            lambda s: jnp.sum(jnp.tanh(grid_sample_zeros_vjp(s, jnp.asarray(x),
                                                             jnp.asarray(y)))))(
            jnp.asarray(src)))
    src_t, x_t, y_t = t(src).requires_grad_(), t(x), t(y)
    torch.tanh(warp_vjp.grid_sample_zeros_vjp(src_t, x_t, y_t)).sum().backward()
    np.testing.assert_allclose(src_t.grad.numpy(), want, rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(5)
    x, y = _coords(2, 16, 24)
    src = t(rng.normal(size=(1, 16, 24, 4))).requires_grad_()
    before = (warp_vjp.warp_gather.launches, warp_vjp.scatter_grad.launches)
    out = warp_vjp.grid_sample_zeros_vjp(src, t(x).requires_grad_(), t(y))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  warp_vjp.warp_plain(src, t(x), t(y)).detach().numpy())
    out.sum().backward()
    assert (warp_vjp.warp_gather.launches, warp_vjp.scatter_grad.launches) == before
    want = warp_vjp.scatter_grad_plain(torch.ones_like(out), t(x), t(y), src.shape)
    np.testing.assert_array_equal(src.grad.numpy(), want.numpy())


# (H, W, C, D) of each dtu_default stage at 512x640 and at the BlendedMVS
# fine-tune's 576x768, and two odd shapes (C not a multiple of 4 takes the
# scalar channel loop)
CARD_SHAPES = [(64, 80, 64, 8), (128, 160, 32, 8), (256, 320, 16, 4),
               (512, 640, 8, 4), (72, 96, 64, 8), (144, 192, 32, 8),
               (288, 384, 16, 4), (576, 768, 8, 4), (64, 64, 4, 4), (48, 64, 3, 2),
               (32, 40, 6, 3)]


@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_launch_plan_holds_the_kernels_assumptions(shape):
    c = shape[2]
    plan = warp_vjp.plan_launch(c)
    lanes, nvec = 1 << plan.lanes_log2, c // plan.vec
    assert plan.vec == (4 if c % 4 == 0 else 1)
    # a power of two of lanes, one vector each where C / 4 <= 32
    assert lanes <= 32 and (lanes >= nvec or lanes == 32) and lanes < 2 * nvec
    assert plan.spl == max(1, 8 // nvec) and warp_vjp.THREADS % lanes == 0
    assert warp_vjp.plan_launch(c, vec4=False).vec == 1  # unaligned pointers


def _coverage(plan, c, n):
    """Hits of each (sample, vector) of one batch row of n samples by the
    kernels' threads (the index arithmetic of csrc/warp_scatter.cu's
    kernels and grid_for, in numpy)."""
    lanes, nvec = 1 << plan.lanes_log2, c // plan.vec
    groups = warp_vjp.THREADS // lanes
    per_block = groups * plan.spl
    tid = np.arange(warp_vjp.THREADS)[None, :, None]
    blk = np.arange(-(-n // per_block))[:, None, None]
    k = np.arange(plan.spl)[None, None, :]
    sample = blk * per_block + (tid >> plan.lanes_log2) + k * groups
    lane = tid & (lanes - 1)
    hits = np.zeros((n, nvec), np.int64)
    for q0 in range(0, nvec, lanes):  # a lane's vectors q, q + lanes, ...
        q = np.broadcast_to(lane + q0, sample.shape)
        ok = (sample < n) & (q < nvec)
        np.add.at(hits, (sample[ok], q[ok]), 1)
    return hits


@pytest.mark.parametrize("shape", CARD_SHAPES + [(20, 36, 132, 1), (3, 5, 1, 1)])
def test_launch_plan_covers_every_sample_once(shape):
    h, w, c, d = shape
    np.testing.assert_array_equal(_coverage(warp_vjp.plan_launch(c), c, d * h * w), 1)


def _card_inputs(shape, device, seed=6):
    h, w, c, d = shape
    inp = stage_inputs(seed, h, w, c, d, nsrc=1, batch=2)
    x, y = _plane_sweep_xy(inp)
    rng = np.random.default_rng(seed)
    cot = rng.normal(size=x.shape + (c,)).astype(np.float32)
    return (t(inp["src"][0], device), t(x, device), t(y, device),
            t(cot, device))


# ... and of the served 832x1152 cascade, where --vis_ETA's attention
# volumes take K2 (on the card only: the planner's cases above cover C)
SERVED_SHAPES = [(104, 144, 64, 8), (208, 288, 32, 8), (416, 576, 16, 4), (832, 1152, 8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES + SERVED_SHAPES)
def test_kernels_match_plain_on_card(cuda_device, shape):
    src, x, y, cot = _card_inputs(shape, cuda_device)
    before = (warp_vjp.warp_gather.launches, warp_vjp.scatter_grad.launches)
    got = warp_vjp.warp_gather(src, x, y)
    dsrc = warp_vjp.scatter_grad(cot, x, y, src.shape)
    torch.cuda.synchronize()
    assert (warp_vjp.warp_gather.launches,
            warp_vjp.scatter_grad.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, warp_vjp.warp_plain(src, x, y),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(
        dsrc, warp_vjp.scatter_grad_plain(cot, x, y, src.shape),
        rtol=1e-4, atol=1e-5)


def _odd_inputs(case, shape, device, seed=7):
    """src, x, y (B, D, H, W) and a cotangent.  "spread": coordinates
    uniform over [-3, W + 2] x [-3, H + 2] (every tap branch, taps far
    apart).  "patch": every coordinate inside one 2x2 source patch (all
    taps on the same four pixels), at quarter-pixel offsets, with integer
    cotangents: each product is a multiple of 1/16 and every partial sum is
    exact in float32 (at most 2^24 sixteenths), so any order of the atomic
    sums gives the plain version's result."""
    h, w, c, d = shape
    rng = np.random.default_rng(seed)
    size = (2, d, h, w)
    if case == "spread":
        x, y = rng.uniform(-3, w + 2, size), rng.uniform(-3, h + 2, size)
        cot = rng.normal(size=size + (c,))
    else:
        quarter = np.array([0.25, 0.5, 0.75])
        x = w // 2 + rng.choice(quarter, size)
        y = h // 3 + rng.choice(quarter, size)
        cot = rng.integers(-4, 5, size + (c,))
    src = rng.normal(size=(2, h, w, c))
    return tuple(t(a, device) for a in (src, x, y, cot))


# "patch" holds up to 512 x 640 samples a pixel (its sums stay exact)
ODD_CASES = [("spread", (64, 80, 64, 8)), ("spread", (256, 320, 16, 4)),
             ("spread", (512, 640, 8, 4)), ("spread", (48, 64, 3, 2)),
             ("patch", (64, 80, 64, 8)), ("patch", (256, 320, 16, 1)),
             ("patch", (512, 640, 8, 1)), ("patch", (48, 64, 3, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("case,shape", ODD_CASES)
def test_kernels_match_plain_on_odd_coordinates(cuda_device, case, shape):
    src, x, y, cot = _odd_inputs(case, shape, cuda_device)
    got = warp_vjp.warp_gather(src, x, y)
    dsrc = warp_vjp.scatter_grad(cot, x, y, src.shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, warp_vjp.warp_plain(src, x, y), rtol=0, atol=1e-6)
    torch.testing.assert_close(dsrc, warp_vjp.scatter_grad_plain(cot, x, y, src.shape),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, row0, rows", [
    ((128, 160, 32, 8), 64, 64),     # DTU-mid stage 2, the second of 2 bands
    ((512, 640, 8, 4), 256, 256),    # DTU-mid stage 4
    ((1152, 1600, 8, 4), 576, 576),  # stage 4 at DTU's raw 1152x1600
    ((64, 80, 64, 8), 16, 24),       # a band that is no multiple of a block
])
def test_kernels_on_a_band_match_plain_on_card(cuda_device, shape, row0, rows):
    """A band's plane-sweep coordinates (reference rows row0 ..) into whole
    sources, as make_spatial_train_step's warp takes them: K2 bitwise the
    plain version, K3 at its tolerance."""
    from mvster_tpu_torch.core.geometry import plane_sweep_coords

    h, w, c, d = shape
    inp = stage_inputs(8, h, w, c, d, nsrc=1, batch=2)
    x, y = plane_sweep_coords(t(inp["src_projs"][0], cuda_device),
                              t(inp["ref_proj"], cuda_device),
                              t(inp["hypo"][:, :, row0:row0 + rows], cuda_device), row0)
    src = t(inp["src"][0], cuda_device)
    cot = t(np.random.default_rng(8).normal(size=(2, d, rows, w, c)), cuda_device)
    got = warp_vjp.warp_gather(src, x, y)
    dsrc = warp_vjp.scatter_grad(cot, x, y, src.shape)
    torch.cuda.synchronize()
    assert got.shape == (2, d, rows, w, c) and dsrc.shape == src.shape
    assert torch.equal(got, warp_vjp.warp_plain(src, x, y))
    torch.testing.assert_close(dsrc, warp_vjp.scatter_grad_plain(cot, x, y, src.shape),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_function_grad_matches_plain_autograd_on_card(cuda_device):
    src, x, y, cot = _card_inputs((128, 160, 32, 8), cuda_device)
    a = src.clone().requires_grad_()
    b = src.clone().requires_grad_()
    (warp_vjp.grid_sample_zeros_vjp(a, x, y) * cot).sum().backward()
    (warp_vjp.warp_plain(b, x, y) * cot).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    src, x, y, cot = _card_inputs((32, 40, 8, 2), cuda_device)
    with pytest.raises(ValueError, match="float32"):
        warp_vjp.warp_gather(src.double(), x, y)
    with pytest.raises(ValueError, match="contiguous"):
        warp_vjp.warp_gather(src.transpose(1, 2), x, y)
    with pytest.raises(ValueError, match="shape"):
        warp_vjp.scatter_grad(cot[..., :4].contiguous(), x, y, src.shape)
    with pytest.raises(ValueError, match="is on"):
        warp_vjp.warp_gather(src, x.cpu(), y)
