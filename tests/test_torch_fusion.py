"""The port's fusion and PLY writer against the JAX package's, on the CPU.

Scenes (numpy, seeded):
  - plane: 5 cameras on an x baseline over a plane at depth 600 (96x128),
    the analytic depth maps, so most pixels pass the filter;
  - random: tests/test_fusion_parity.make_scene's smooth random depth map
    and mildly rotated cameras (96x128), 4 sources, so 20-50% of the pixels
    agree with a source, many of them near a threshold.
Tolerances: the reprojection within 1e-4 px and rtol 1e-5 in depth; the
masks equal but at pixels whose reprojection distance or relative depth
difference lies within 1e-4 of its threshold (counted; the port repeats
the JAX package's operations, so none differs); the fused depth and
the fused points at rtol 1e-5 of their distance from the origin, matched
by pixel.  The PLY files are
byte-equal.
On the card (marked `cuda`, skipped without one): geometric_filter and
fuse_scene against the CPU on the plane scene, by the same rules.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_masks_agree, cuda_device, fusion_edge_pixels  # noqa: F401
from mvster_tpu_torch.infer import fusion, ply

H, W = 96, 128


def plane_scene(n_views=5, z=600.0):
    focal = 1.1 * W
    k = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    extrs = []
    for v in range(n_views):
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = 30.0 * (v - n_views // 2)
        extrs.append(e)
    depths = [np.full((H, W), z, np.float32) for _ in range(n_views)]
    return depths, [k] * n_views, extrs


def random_scene(seed=0, n_src=4):
    """make_scene's smooth random depth map seen by every view in its own
    frame, the sources' cameras from make_scene at other seeds: 20-50% of
    the pixels agree with a source, most near a threshold."""
    from test_fusion_parity import make_scene

    d0, _, k, e0, _ = make_scene(seed, H, W)
    srcs = [make_scene(100 * seed + i + 1, H, W) for i in range(n_src)]
    return [d0] * (n_src + 1), [k] * (n_src + 1), [e0] + [s[4] for s in srcs]


SCENES = {"plane": plane_scene, "random": random_scene}


def split(scene):
    """(ref depth, K, E) and the sources' stacks, as numpy."""
    depths, intrs, extrs = scene
    return (depths[0], intrs[0], extrs[0], np.stack(depths[1:]), np.stack(intrs[1:]),
            np.stack(extrs[1:]))


def jax_filter(args, **kw):
    import jax.numpy as jnp

    from mvster_tpu.infer.fusion import geometric_filter

    d, k, e, sd, sk, se = (jnp.asarray(a) for a in args)
    conf = jnp.ones_like(d) * 0.8
    return [np.asarray(x) for x in geometric_filter(d, conf, k, e, sd, sk, se, **kw)]


def port_filter(args, device="cpu", **kw):
    d, k, e, sd, sk, se = (torch.from_numpy(np.asarray(a)).to(device) for a in args)
    conf = torch.ones_like(d) * 0.8
    return [x.cpu().numpy() for x in fusion.geometric_filter(d, conf, k, e, sd, sk, se, **kw)]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_reproject_matches_jax(name):
    import jax.numpy as jnp

    from mvster_tpu.infer.fusion import _reproject as jax_reproject

    args = split(SCENES[name]())
    got = [x.numpy() for x in fusion._reproject(*(torch.from_numpy(a) for a in args))]
    d, k, e, sd, sk, se = args
    per_src = [jax_reproject(*(jnp.asarray(a) for a in (d, k, e, sd[i], sk[i], se[i])))
               for i in range(len(sd))]
    want = [np.stack([np.asarray(out[j]) for out in per_src]) for j in range(3)]
    assert got[0].shape == (len(sd), H, W)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)


@pytest.mark.parametrize("thres_view", [1, 3])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_geometric_filter_matches_jax(name, thres_view):
    args = split(SCENES[name]())
    kw = dict(conf_thresh=0.5, thres_view=thres_view)
    got, want = port_filter(args, **kw), jax_filter(args, **kw)
    edge = fusion_edge_pixels(*args)
    differ = 0
    for what, g, w in zip(("final", "geo", "photo"), (got[0], got[2], got[3]),
                          (want[0], want[2], want[3])):
        assert g.dtype == np.bool_ and g.shape == (H, W)
        differ += assert_masks_agree(g, w, edge, what)
    print(f"{name}: {int(edge.sum())} edge pixels, {differ} mask pixels differ")
    same = got[2] == want[2]
    np.testing.assert_allclose(got[1][same], want[1][same], rtol=1e-5)
    if name == "plane":  # the analytic maps pass where the sources see the plane
        assert got[0].mean() > 0.5
        np.testing.assert_allclose(got[1][got[0]], 600.0, rtol=1e-5)


def points_by_pixel(xyz, masks, views):
    """The fused (N, 3) cloud as one (H, W, 3) map a view, NaN where no point."""
    out, start = {}, 0
    for v in views:
        m = masks[v]["final"]
        grid = np.full(m.shape + (3,), np.nan, np.float32)
        grid[m] = xyz[start:start + m.sum()]
        start += m.sum()
        out[v] = grid
    assert start == len(xyz)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fuse_scene_matches_jax(name):
    from mvster_tpu.infer.fusion import fuse_scene as jax_fuse_scene

    depths, intrs, extrs = SCENES[name]()
    n = len(depths)
    ids = list(range(n))
    d = dict(enumerate(depths))
    k = dict(enumerate(intrs))
    e = dict(enumerate(extrs))
    rng = np.random.default_rng(1)
    confs = {v: rng.uniform(0.3, 1.0, (H, W)).astype(np.float32) for v in ids}
    imgs = {v: rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for v in ids}
    pairs = [(v, [u for u in ids if u != v]) for v in ids]
    kw = dict(conf_thresh=0.5, thres_view=2)
    got = fusion.fuse_scene(pairs, d, confs, k, e, imgs, **kw, device="cpu")
    want = jax_fuse_scene(pairs, d, confs, k, e, imgs, **kw)
    differ = 0
    for v, srcs in pairs:
        edge = fusion_edge_pixels(d[v], k[v], e[v], np.stack([d[u] for u in srcs]),
                                  np.stack([k[u] for u in srcs]), np.stack([e[u] for u in srcs]))
        for kind in ("final", "geo", "photo"):
            differ += assert_masks_agree(got[2][v][kind], want[2][v][kind], edge, f"{v} {kind}")
    print(f"{name}: {differ} mask pixels differ, {len(got[0])} points (JAX {len(want[0])})")
    ours, theirs = points_by_pixel(got[0], got[2], ids), points_by_pixel(want[0], want[2], ids)
    for v in ids:
        both = ~np.isnan(ours[v][..., 0]) & ~np.isnan(theirs[v][..., 0])
        # rtol on each point's position (a coordinate near 0 has no own scale)
        gap = np.linalg.norm(ours[v][both] - theirs[v][both], axis=-1)
        assert (gap <= 1e-5 * np.linalg.norm(theirs[v][both], axis=-1)).all(), gap.max()
    if name == "plane":
        assert len(got[0]) > n * H * W // 2
    if differ == 0:
        np.testing.assert_array_equal(got[1], want[1])


def test_fuse_scene_needs_a_device():
    """No default device: a caller that names none gets an error, not a
    fusion on the host."""
    depths, intrs, extrs = plane_scene(n_views=2)
    args = ([(0, [1])], dict(enumerate(depths)), dict(enumerate(depths)),
            dict(enumerate(intrs)), dict(enumerate(extrs)))
    with pytest.raises(TypeError, match="device"):
        fusion.fuse_scene(*args)
    xyz, _, masks = fusion.fuse_scene(*args, thres_view=1, device="cpu")
    assert masks[0]["final"].mean() > 0.5 and len(xyz) == masks[0]["final"].sum()


@pytest.mark.parametrize("colors", [True, False])
def test_write_ply_is_byte_equal_to_jax(tmp_path, colors):
    from mvster_tpu.infer.ply import camera_pointcloud as jax_camera_pointcloud
    from mvster_tpu.infer.ply import write_ply as jax_write_ply

    rng = np.random.default_rng(2)
    depth = rng.uniform(-50, 900, (H, W)).astype(np.float32)  # some pixels dropped
    k = plane_scene()[1][0]
    img = (rng.uniform(size=(H, W, 3)) * 255).astype(np.uint8) if colors else None
    xyz, rgb = ply.camera_pointcloud(depth, k, img)
    jxyz, jrgb = jax_camera_pointcloud(depth, k, img)
    np.testing.assert_array_equal(xyz, jxyz)
    assert (rgb is None) == (jrgb is None) == (not colors)
    ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "theirs.ply")
    ply.write_ply(ours, xyz, rgb)
    jax_write_ply(theirs, xyz, rgb)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back_xyz, back_rgb = ply.read_ply(theirs)
    np.testing.assert_array_equal(back_xyz, xyz)
    if colors:
        np.testing.assert_array_equal(back_rgb, rgb)
    else:
        assert back_rgb is None


def test_read_ply_takes_ascii(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
                    "property float y\nproperty float z\nproperty uchar red\n"
                    "property uchar green\nproperty uchar blue\nend_header\n"
                    "1 2 3 10 20 30\n4 5 6 40 50 60\n")
    xyz, rgb = ply.read_ply(str(path))
    np.testing.assert_array_equal(xyz, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(rgb, [[10, 20, 30], [40, 50, 60]])


@pytest.mark.cuda
def test_geometric_filter_on_card_matches_cpu(cuda_device):
    """The filter on the card against the CPU on the plane scene (the random
    one needs JAX's test module): masks equal but at edge pixels, the fused
    depth at rtol 1e-5 where the masks agree."""
    args = split(plane_scene())
    got = port_filter(args, cuda_device, thres_view=2)
    want = port_filter(args, thres_view=2)
    edge = fusion_edge_pixels(*args)
    for i in (0, 2, 3):
        assert_masks_agree(got[i], want[i], edge)
    same = got[2] == want[2]
    np.testing.assert_allclose(got[1][same], want[1][same], rtol=1e-5)


@pytest.mark.cuda
def test_fuse_scene_on_card_matches_cpu(cuda_device):
    """fuse_scene on the card against the CPU on the plane scene, every view
    a reference: the masks equal but at edge pixels (counted), the fused
    points bitwise where no mask differs (else matched by pixel at rtol
    1e-5 of their distance from the origin), all on the plane."""
    depths, intrs, extrs = plane_scene()
    n = len(depths)
    ids = list(range(n))
    d, k, e = dict(enumerate(depths)), dict(enumerate(intrs)), dict(enumerate(extrs))
    rng = np.random.default_rng(2)
    confs = {v: rng.uniform(0.3, 1.0, (H, W)).astype(np.float32) for v in ids}
    imgs = {v: rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for v in ids}
    pairs = [(v, [u for u in ids if u != v]) for v in ids]
    kw = dict(conf_thresh=0.5, thres_view=2)
    got = fusion.fuse_scene(pairs, d, confs, k, e, imgs, **kw, device=cuda_device)
    want = fusion.fuse_scene(pairs, d, confs, k, e, imgs, **kw, device="cpu")
    differ = 0
    for v, srcs in pairs:
        edge = fusion_edge_pixels(d[v], k[v], e[v], np.stack([d[u] for u in srcs]),
                                  np.stack([k[u] for u in srcs]), np.stack([e[u] for u in srcs]))
        for kind in ("final", "geo", "photo"):
            differ += assert_masks_agree(got[2][v][kind], want[2][v][kind], edge, f"{v} {kind}")
    if differ == 0:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:
        ours, theirs = points_by_pixel(got[0], got[2], ids), points_by_pixel(want[0], want[2], ids)
        for v in ids:
            both = ~np.isnan(ours[v][..., 0]) & ~np.isnan(theirs[v][..., 0])
            gap = np.linalg.norm(ours[v][both] - theirs[v][both], axis=-1)
            assert (gap <= 1e-5 * np.linalg.norm(theirs[v][both], axis=-1)).all(), gap.max()
    assert len(got[0]) > n * H * W // 2
    assert np.abs(got[0][:, 2] - 600.0).max() < 600.0 * 1e-3
