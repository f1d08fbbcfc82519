"""The port's cost volume against the JAX package, and its CUDA kernel against plain.

CPU: kernels/cost_volume.build_cost_volume (plain PyTorch) against the JAX
XLA formulation at atol 1e-5, and against the JAX Pallas kernel run in
interpret mode at rtol 1e-4 / atol 1e-5 (that entry reassociates its
coordinate arithmetic by up to ~1e-4 px, tests/test_pallas_warp.py).
CPU, within the port: the kernel's launch planner (plan_launch), which
picks its instance and block for every D and G.
CUDA (marked `cuda`, skipped without a card): the hand-written kernel
against its plain version on the card at atol/rtol 1e-4, at the DTU-mid
stages and at other depth and group counts.
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, stage_inputs, t  # noqa: F401
from mvster_tpu_torch.kernels import warp_correlate
from mvster_tpu_torch.kernels.cost_volume import build_cost_volume


def _port(inp, **kw):
    return build_cost_volume(
        t(inp["ref"]), t(inp["src"]), t(inp["ref_proj"]), t(inp["src_projs"]),
        t(inp["hypo"]), **kw,
    ).numpy()


def _jax(inp, impl, **kw):
    import jax.numpy as jnp

    from mvster_tpu.kernels.cost_volume import build_cost_volume as jax_bcv

    out, fallbacks = jax_bcv(
        jnp.asarray(inp["ref"]), jnp.asarray(inp["src"]),
        jnp.asarray(inp["ref_proj"]), jnp.asarray(inp["src_projs"]),
        jnp.asarray(inp["hypo"]), impl=impl, with_fallbacks=True, **kw,
    )
    assert int(fallbacks) == 0, f"JAX {impl} path fell back to XLA"
    return np.asarray(out)


@pytest.mark.parametrize("group_cor", [True, False])
@pytest.mark.parametrize("attn_fuse_d", [True, False])
def test_plain_matches_jax_xla(attn_fuse_d, group_cor):
    # unit-normal C=8 features, G=4, D=4, two source views at 64x64; the
    # geometry is bit-exact with JAX, so only sum order differs (~1e-6)
    inp = stage_inputs(0, 64, 64, 8, 4, nsrc=2)
    kw = dict(group_cor=group_cor, group_dim=4, attn_temp=2.0,
              attn_fuse_d=attn_fuse_d)
    np.testing.assert_allclose(_port(inp, **kw), _jax(inp, "xla", **kw),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("attn_fuse_d", [True, False])
@pytest.mark.parametrize("d,g,c", [(2, 2, 8), (3, 2, 8), (16, 16, 64)])
def test_plain_matches_jax_xla_at_other_counts(d, g, c, attn_fuse_d):
    # depth and group counts off dtu_default's (8, 8, 4, 4) / (8, 8, 4, 4)
    inp = stage_inputs(10 + d, 32, 40, c, d, nsrc=2)
    kw = dict(group_cor=True, group_dim=g, attn_temp=2.0, attn_fuse_d=attn_fuse_d)
    np.testing.assert_allclose(_port(inp, **kw), _jax(inp, "xla", **kw),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dcg,want", [
    # (D, C, G) -> (capacity, float4 split, pixels a block); threads = P * D
    ((8, 64, 8), (8, 1, 32)),     # DTU-mid stage 1: C/G = 8
    ((8, 32, 8), (8, 1, 32)),     # stage 2: C/G = 4
    ((4, 16, 4), (4, 1, 64)),     # stage 3
    ((4, 8, 4), (4, 2, 64)),      # stage 4: C/G = 2, a float4 spans two groups
    ((16, 64, 64), (64, 4, 16)),  # C/G = 1: a float4 spans four groups
    ((3, 8, 2), (4, 1, 85)),      # 255 threads
    ((2, 16, 16), (16, 4, 128)),
    ((3, 3, 3), (4, 0, 85)),      # C % 4 != 0: scalar loads
    ((5, 12, 2), (4, 0, 51)),     # C/G = 6: scalar loads
    ((1, 8, 1), (4, 1, 256)),
    ((256, 32, 32), (32, 4, 1)),
    ((17, 64, 32), (32, 2, 15)),
])
def test_plan_launch(dcg, want):
    d, c, g = dcg
    plan = warp_correlate.plan_launch(d, c, g)
    assert (plan.maxg, plan.split, plan.pixels) == want
    assert plan.threads == plan.pixels * d <= warp_correlate.THREADS <= 1024
    assert plan.smem == 2 * plan.threads * 4  # two (D, P) float buffers of logits
    assert plan.maxg >= g
    # misaligned pointers take the scalar loads, at the same block
    assert warp_correlate.plan_launch(d, c, g, False) == plan._replace(split=0)


@pytest.mark.parametrize("d,c,g", [(4, 8, 3), (4, 12, 8), (4, 128, 128), (4, 8, 0),
                                   (0, 8, 4), (257, 8, 4)])
def test_plan_launch_rejects_what_the_kernel_does_not_take(d, c, g):
    with pytest.raises(ValueError, match="takes"):
        warp_correlate.plan_launch(d, c, g)


@pytest.mark.parametrize("attn_fuse_d", [True, False])
def test_plain_matches_jax_pallas_interpret(attn_fuse_d):
    """The Pallas K1 body itself (interpret mode), on the smooth textured
    plane scene as features (C=3, G=3), as tests/test_pallas_warp.py runs it."""
    from jax.experimental.pallas import tpu as pltpu

    from helpers import plane_scene_sample
    from mvster_tpu_torch.core.geometry import compose_projection

    sample = plane_scene_sample(1)
    imgs = sample["imgs"]  # (1, 3, 64, 64, 3)
    comp = compose_projection(t(sample["proj_matrices"]["stage4"])).numpy()
    rng = np.random.default_rng(1)
    itv = np.arange(4, dtype=np.float32) / 3
    hypo = (1.0 / (1 / 935.0 + (1 / 425.0 - 1 / 935.0) * itv)).astype(np.float32)
    hypo = hypo[None, :, None, None] * rng.uniform(0.97, 1.03, (1, 4, 64, 64))
    inp = dict(ref=imgs[:, 0], src=np.moveaxis(imgs[:, 1:], 1, 0),
               ref_proj=comp[:, 0],
               src_projs=np.ascontiguousarray(np.moveaxis(comp[:, 1:], 1, 0)),
               hypo=hypo.astype(np.float32))
    kw = dict(group_cor=True, group_dim=3, attn_temp=2.0, attn_fuse_d=attn_fuse_d)
    with pltpu.force_tpu_interpret_mode():
        got = _jax(inp, "pallas", **kw)
    np.testing.assert_allclose(_port(inp, **kw), got, rtol=1e-4, atol=1e-5)


def test_train_route_matches_jax_xla_and_its_gradients():
    """impl="warp" (the training route: detached coordinates, the autograd
    warp) against the JAX package's impl="xla" (grid_sample_zeros_vjp):
    the volume at atol 1e-5, and the gradients of a weighted sum with
    respect to the reference and source features at rtol 1e-4 / atol 1e-6."""
    import jax
    import jax.numpy as jnp

    from mvster_tpu.kernels.cost_volume import build_cost_volume as jax_bcv

    inp = stage_inputs(6, 32, 48, 8, 4, nsrc=2, batch=2)
    weights = np.random.default_rng(6).normal(size=(2, 4, 32, 48, 4)).astype(np.float32)
    kw = dict(group_cor=True, group_dim=4, attn_temp=2.0, attn_fuse_d=True)

    def jax_loss(ref, src):
        out = jax_bcv(ref, src, jnp.asarray(inp["ref_proj"]), jnp.asarray(inp["src_projs"]),
                      jnp.asarray(inp["hypo"]), impl="xla", **kw)
        return jnp.sum(out * weights), out

    (_, want), (g_ref, g_src) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(inp["ref"]), jnp.asarray(inp["src"]))
    ref, src = t(inp["ref"]).requires_grad_(), t(inp["src"]).requires_grad_()
    got = build_cost_volume(ref, src, t(inp["ref_proj"]), t(inp["src_projs"]),
                            t(inp["hypo"]), impl="warp", **kw)
    (got * t(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref.grad.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(src.grad.numpy(), np.asarray(g_src), rtol=1e-4, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    inp = stage_inputs(3, 32, 32, 8, 8, nsrc=2)
    before = warp_correlate.fused_cost_volume.launches
    args = (t(inp["ref"]), t(inp["src"]), t(inp["ref_proj"]),
            t(inp["src_projs"]), t(inp["hypo"]), 4, 2.0, True)
    out = warp_correlate.fused_cost_volume(*args)
    assert warp_correlate.fused_cost_volume.launches == before
    np.testing.assert_array_equal(
        out.numpy(), warp_correlate.fused_cost_volume_plain(*args).numpy()
    )


# DTU-mid stage shapes (H, W, C, D, G) of dtu_default at 512x640
DTU_MID_STAGES = [(64, 80, 64, 8, 8), (128, 160, 32, 8, 8),
                  (256, 320, 16, 4, 4), (512, 640, 8, 4, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("attn_fuse_d", [True, False])
@pytest.mark.parametrize("shape", DTU_MID_STAGES + [(48, 64, 8, 8, 4),
                                                    (64, 64, 16, 4, 8)])
def test_kernel_matches_plain_on_card(cuda_device, shape, attn_fuse_d):
    # identical coordinates in both (see core/geometry.py), so only the
    # sum order of the correlation and softmax differ
    h, w, c, d, g = shape
    inp = stage_inputs(4, h, w, c, d, nsrc=4)
    args = [t(inp[k], cuda_device) for k in
            ("ref", "src", "ref_proj", "src_projs", "hypo")]
    before = warp_correlate.fused_cost_volume.launches
    got = warp_correlate.fused_cost_volume(*args, g, 2.0, attn_fuse_d)
    want = warp_correlate.fused_cost_volume_plain(*args, g, 2.0, attn_fuse_d)
    torch.cuda.synchronize()
    assert warp_correlate.fused_cost_volume.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_fuse_d", [True, False])
@pytest.mark.parametrize("shape", [
    (48, 64, 16, 2, 2), (48, 64, 16, 3, 2), (48, 64, 64, 16, 16), (48, 64, 16, 2, 16),
    (48, 64, 32, 3, 16), (40, 56, 64, 16, 2),
    (32, 48, 3, 3, 3), (32, 48, 3, 16, 1),  # C = 3: the scalar path
])
def test_kernel_takes_other_counts_on_card(cuda_device, shape, attn_fuse_d):
    """Depth and group counts off dtu_default: D in {2, 3, 16}, G in {2, 16}
    (every float4 split) and C = 3."""
    test_kernel_matches_plain_on_card(cuda_device, shape, attn_fuse_d)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    inp = stage_inputs(5, 32, 32, 8, 2, nsrc=1)
    args = [t(inp[k], cuda_device) for k in
            ("ref", "src", "ref_proj", "src_projs", "hypo")]
    with pytest.raises(ValueError, match="groups that divide C"):
        warp_correlate.fused_cost_volume(*args, 3, 2.0, True)  # G=3 does not divide C=8
    inp128 = stage_inputs(5, 16, 16, 128, 2, nsrc=1)
    with pytest.raises(ValueError, match="G <= 64"):
        warp_correlate.fused_cost_volume(
            *[t(inp128[k], cuda_device) for k in
              ("ref", "src", "ref_proj", "src_projs", "hypo")], 128, 2.0, True)
    inp = stage_inputs(5, 32, 32, 8, 4, nsrc=1)
    args = [t(inp[k], cuda_device) for k in
            ("ref", "src", "ref_proj", "src_projs", "hypo")]
    with pytest.raises(ValueError, match="contiguous"):
        warp_correlate.fused_cost_volume(
            args[0].transpose(1, 2), *args[1:], 4, 2.0, True)
    with pytest.raises(ValueError, match="float32"):
        warp_correlate.fused_cost_volume(args[0].double(), *args[1:], 4, 2.0, True)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_fuse_d", [True, False])
@pytest.mark.parametrize("shape, row0, rows", [
    ((128, 160, 32, 8, 8), 64, 64),   # stage 2 of DTU-mid, the second of 2 bands
    ((256, 320, 16, 4, 4), 192, 64),  # stage 3, the last of 4
    ((64, 80, 64, 8, 8), 16, 24),     # a band that is no multiple of a block
])
def test_kernel_on_a_band_matches_plain_on_card(cuda_device, shape, row0, rows,
                                                attn_fuse_d):
    """K1 with a band offset and whole sources (Hs != H) against its plain
    version on the same band, and against the whole volume's rows."""
    h, w, c, d, g = shape
    inp = stage_inputs(6, h, w, c, d, nsrc=4)
    ref, src, ref_proj, src_projs, hypo = (t(inp[k], cuda_device) for k in
                                           ("ref", "src", "ref_proj", "src_projs", "hypo"))
    band = slice(row0, row0 + rows)
    args = (ref[:, band].contiguous(), src, ref_proj, src_projs,
            hypo[:, :, band].contiguous(), g, 2.0, attn_fuse_d, row0)
    got = warp_correlate.fused_cost_volume(*args)
    want = warp_correlate.fused_cost_volume_plain(*args)
    whole = warp_correlate.fused_cost_volume(ref, src, ref_proj, src_projs, hypo, g, 2.0,
                                             attn_fuse_d)
    torch.cuda.synchronize()
    assert got.shape == (1, d, rows, w, g)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # one pixel's arithmetic is the same whichever rows the launch holds
    assert torch.equal(got, whole[:, :, band])
