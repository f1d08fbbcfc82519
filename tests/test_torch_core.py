"""The port's core/ (geometry, sampling, hypotheses) against the JAX package on the CPU.

Inputs are made with numpy from seeds.  The geometry is written as the same
FMA chains that the JAX package's HIGHEST-precision matmul runs on the CPU,
so it is compared bit for bit; sampling and resizes at 1e-6 (sum order).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from _torch_parity import t
from helpers import synthetic_cameras
import mvster_tpu.core.geometry as jgeo
import mvster_tpu.core.hypothesis as jhyp
import mvster_tpu.core.sampling as jsmp
import mvster_tpu_torch.core.geometry as geo
import mvster_tpu_torch.core.hypothesis as hyp
import mvster_tpu_torch.core.sampling as smp


def _cams(seed, batch=2, nviews=4, h=64, w=80):
    rng = np.random.default_rng(seed)
    projs = synthetic_cameras(rng, batch, nviews, h, w)["stage4"]
    comp = np.asarray(jgeo.compose_projection(jnp.asarray(projs)))
    return projs, comp


def _hypo(seed, b, d, h, w):
    rng = np.random.default_rng(seed)
    base = np.linspace(425.0, 935.0, d, dtype=np.float32)
    return (base[None, :, None, None]
            * rng.uniform(0.95, 1.05, (b, d, h, w))).astype(np.float32)


def test_inverse_3x3_and_affine_4x4_match_jax():
    _, comp = _cams(0)
    np.testing.assert_array_equal(
        geo.inverse_3x3(t(comp[..., :3, :3])).numpy(),
        np.asarray(jgeo.inverse_3x3(jnp.asarray(comp[..., :3, :3]))),
    )
    np.testing.assert_array_equal(
        geo.inverse_affine_4x4(t(comp)).numpy(),
        np.asarray(jgeo.inverse_affine_4x4(jnp.asarray(comp))),
    )


def test_compose_projection_matches_jax_bitwise():
    projs, comp = _cams(1)
    np.testing.assert_array_equal(geo.compose_projection(t(projs)).numpy(), comp)


def test_plane_sweep_rt_matches_jax_bitwise():
    _, comp = _cams(2)
    rot, trans = geo.plane_sweep_rt(t(comp[:, 1]), t(comp[:, 0]))
    jrot, jtrans = jgeo.plane_sweep_rt(jnp.asarray(comp[:, 1]), jnp.asarray(comp[:, 0]))
    np.testing.assert_array_equal(rot.numpy(), np.asarray(jrot))
    np.testing.assert_array_equal(trans.numpy(), np.asarray(jtrans))


@pytest.mark.parametrize("hw", [(64, 80), (512, 640)])
def test_plane_sweep_coords_match_jax_bitwise(hw):
    # at 512x640 too: one coordinate ulp there moves the sample ~6e-5 px
    h, w = hw
    _, comp = _cams(3, batch=1, h=h, w=w)
    hypo = _hypo(3, 1, 2, h, w)
    x, y = geo.plane_sweep_coords(t(comp[:, 2]), t(comp[:, 0]), t(hypo))
    jx, jy = jgeo.plane_sweep_coords(jnp.asarray(comp[:, 2]),
                                     jnp.asarray(comp[:, 0]), jnp.asarray(hypo))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_plane_sweep_coords_z_zero_guard():
    # identical cameras and a zero-depth plane: z == 0 everywhere, which the
    # guard turns into 1e-9 instead of 0/0
    _, comp = _cams(4, batch=1, h=16, w=16)
    hypo = np.zeros((1, 2, 16, 16), np.float32)
    x, y = geo.plane_sweep_coords(t(comp[:, 0]), t(comp[:, 0]), t(hypo))
    jx, jy = jgeo.plane_sweep_coords(jnp.asarray(comp[:, 0]),
                                     jnp.asarray(comp[:, 0]), jnp.asarray(hypo))
    assert np.isfinite(x.numpy()).all() and np.isfinite(y.numpy()).all()
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_bilinear_sample_matches_jax_with_border_taps():
    rng = np.random.default_rng(5)
    img = rng.normal(size=(12, 17, 5)).astype(np.float32)
    # coordinates inside, straddling every border, and far outside
    x = rng.uniform(-3.0, 20.0, size=(7, 9)).astype(np.float32)
    y = rng.uniform(-3.0, 15.0, size=(7, 9)).astype(np.float32)
    x[0, :3] = [-1e12, 1e12, np.float32(16.5)]
    got = smp.bilinear_sample(t(img), t(x), t(y)).numpy()
    want = np.asarray(jsmp.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                           jnp.asarray(y)))
    assert got.shape == (7, 9, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_grid_sample_zeros_batched_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.normal(size=(2, 20, 24, 8)).astype(np.float32)
    x = rng.uniform(-2.0, 26.0, size=(2, 3, 20, 24)).astype(np.float32)
    y = rng.uniform(-2.0, 22.0, size=(2, 3, 20, 24)).astype(np.float32)
    got = smp.grid_sample_zeros(t(img), t(x), t(y)).numpy()
    want = np.asarray(jsmp.grid_sample_zeros(jnp.asarray(img), jnp.asarray(x),
                                             jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(8, 10, 16, 20), (8, 10, 13, 7)])
def test_resize_bilinear_align_corners_matches_jax(size):
    h, w, oh, ow = size
    x = np.random.default_rng(7).normal(size=(2, h, w, 3)).astype(np.float32)
    got = smp.resize_bilinear_align_corners(t(x), oh, ow).numpy()
    want = np.asarray(jsmp.resize_bilinear_align_corners(jnp.asarray(x), oh, ow))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [(4, 8, 10, 4, 16, 20), (4, 8, 10, 6, 12, 9)])
def test_resize_trilinear_align_corners_matches_jax(size):
    d, h, w, od, oh, ow = size
    x = np.random.default_rng(8).uniform(1e-3, 2e-3, size=(2, d, h, w)).astype(np.float32)
    got = smp.resize_trilinear_align_corners(t(x), od, oh, ow).numpy()
    want = np.asarray(jsmp.resize_trilinear_align_corners(jnp.asarray(x), od, oh, ow))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_init_samplers_match_jax():
    dv = np.array([[425.0, 935.0], [300.0, 800.0]], np.float32)
    for ours, theirs in ((hyp.init_range, jhyp.init_range),
                         (hyp.init_inverse_range, jhyp.init_inverse_range)):
        got = ours(t(dv), 8, 6, 10)
        assert got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs(jnp.asarray(dv), 8, 6, 10)),
                                   rtol=1e-6)


def test_schedule_inverse_range_matches_jax():
    rng = np.random.default_rng(9)
    depth = rng.uniform(450.0, 900.0, size=(2, 8, 10)).astype(np.float32)
    itv = np.float32(2e-5)
    inv_min, inv_max = 1.0 / depth + 0.5 * itv, 1.0 / depth - 0.5 * itv
    got = hyp.schedule_inverse_range(t(inv_min), t(inv_max), 4, 16, 20).numpy()
    want = np.asarray(jhyp.schedule_inverse_range(
        jnp.asarray(inv_min), jnp.asarray(inv_max), 4, 16, 20))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_range_matches_jax():
    rng = np.random.default_rng(10)
    depth = rng.uniform(450.0, 900.0, size=(2, 8, 10)).astype(np.float32)
    interval = np.array([2.5, 4.0], np.float32)
    got = hyp.schedule_range(t(depth), 8, t(interval), 16, 20).numpy()
    want = np.asarray(jhyp.schedule_range(jnp.asarray(depth), 8,
                                          jnp.asarray(interval), 16, 20))
    np.testing.assert_allclose(got, want, rtol=1e-6)
