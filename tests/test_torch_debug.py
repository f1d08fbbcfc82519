"""The port's debug dumps against the JAX package's, on the CPU.

- utils/debug.attention_maps against mvster_tpu.utils.debug.attention_maps
  on the same numpy inputs (_torch_parity.stage_inputs at 32x40, 3 source
  views, both group widths), at atol 1e-5: the same warp, correlation and
  softmax (without the unused temperature, as in JAX).
- MVS4Net.forward(return_debug=True): each stage's debug_features and
  debug_proj against the JAX model's (model.apply(return_debug=True)), the
  same perturbed flax weights through tools/convert.py; the features at
  atol 1e-5, the composed projections bitwise (core.geometry's FMA chains).
- tools.test.main --vis_ETA --vis_mono of both packages on one synthetic
  scan (_torch_parity.write_plane_scan: a textured plane, 128x128, 3
  views) with fpn_base_channel, reg_channel and the group widths 4: the
  same set of files under vis_ETA/ and vis_mono/, the same shapes and
  dtypes, the stage-4 features at atol 1e-5 and each stage's attention
  volumes at atol 1e-4 on at least 99% of their entries (an argmax that
  flips at a near-tie moves the next stage's hypothesis window at that
  pixel; the model tests bound those stage by stage).
"""

import os

import numpy as np
import pytest
import torch

from _torch_parity import jax_variables, stage_inputs, t, write_plane_scan
from helpers import synthetic_sample
from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
from mvster_tpu_torch.tools.weights import state_dict_from_jax
from mvster_tpu_torch.utils.debug import attention_maps

NARROW = ["--fpn_base_channel", "4", "--reg_channel", "4", "--group_cor_dim", "4,4,4,4"]
CFG = dict(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
           fpn_base_channel=4, reg_channel=4, attn_temp=2.0)


@pytest.mark.parametrize("group_dim", [8, 4])
def test_attention_maps_match_jax(group_dim):
    import jax.numpy as jnp

    from mvster_tpu.utils.debug import attention_maps as jax_attention_maps

    inp = stage_inputs(7, 32, 40, 16, 8, nsrc=3, batch=2)
    want = jax_attention_maps(
        jnp.asarray(inp["ref"]), [jnp.asarray(s) for s in inp["src"]],
        jnp.asarray(inp["ref_proj"]), [jnp.asarray(p) for p in inp["src_projs"]],
        jnp.asarray(inp["hypo"]), group_dim=group_dim)
    got = attention_maps(t(inp["ref"]), list(t(inp["src"])), t(inp["ref_proj"]),
                         list(t(inp["src_projs"])), t(inp["hypo"]), group_dim=group_dim)
    assert got.shape == (3, 2, 8, 32, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the temperature is accepted and unused, as in the JAX function
    same = attention_maps(t(inp["ref"]), list(t(inp["src"])), t(inp["ref_proj"]),
                          list(t(inp["src_projs"])), t(inp["hypo"]), group_dim=group_dim,
                          attn_temp=7.0)
    assert torch.equal(same, got)


def test_return_debug_matches_jax():
    import jax
    import jax.numpy as jnp

    from mvster_tpu.models import MVS4Net as JaxMVS4Net
    from mvster_tpu.models import MVS4NetConfig as JaxConfig

    sample = synthetic_sample(0, nviews=3, h=64, w=64)
    variables = jax_variables(JaxConfig(**CFG), sample, seed=0)
    jax_out = JaxMVS4Net(JaxConfig(**CFG)).apply(
        variables, jnp.asarray(sample["imgs"]),
        {k: jnp.asarray(v) for k, v in sample["proj_matrices"].items()},
        jnp.asarray(sample["depth_values"]), train=False, return_debug=True)
    model = MVS4Net(MVS4NetConfig(**CFG))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        out = model.eval()(t(sample["imgs"]),
                           {k: t(v) for k, v in sample["proj_matrices"].items()},
                           t(sample["depth_values"]), return_debug=True)
        plain = model(t(sample["imgs"]),
                      {k: t(v) for k, v in sample["proj_matrices"].items()},
                      t(sample["depth_values"]))
    for s in range(1, 5):
        got, want = out[f"stage{s}"], jax.tree_util.tree_map(np.asarray, jax_out[f"stage{s}"])
        assert got["debug_features"].shape == want["debug_features"].shape
        np.testing.assert_allclose(got["debug_features"].numpy(), want["debug_features"],
                                   atol=1e-5)
        np.testing.assert_array_equal(got["debug_proj"].numpy(), want["debug_proj"])
        # the debug fields are additive: the rest is the plain forward's
        assert torch.equal(got["depth"], plain[f"stage{s}"]["depth"])
        assert "debug_features" not in plain[f"stage{s}"]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both inference tools with --vis_ETA --vis_mono on one scan."""
    from mvster_tpu.models import MVS4Net as JaxMVS4Net
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu.tools import test as jax_test
    from mvster_tpu_torch.tools import test as port_test

    root = tmp_path_factory.mktemp("vis")
    scan = write_plane_scan(str(root), n_views=3, h=128, w=128)[0]
    config = JaxConfig(**CFG)
    variables = jax_variables(config, synthetic_sample(0, nviews=3, h=128, w=128), 0)
    ckpt = str(root / "model.ckpt")
    torch.save({"model": state_dict_from_jax(variables)}, ckpt)
    out = {}
    for name in ("jax", "port"):
        outdir = str(root / name)
        argv = ["--testpath", str(root), "--testlist", scan, "--loadckpt", ckpt,
                "--outdir", outdir, "--num_view", "3", "--max_h", "128", "--max_w", "128",
                "--group_cor", "--inverse_depth", "--attn_temp", "2", "--vis_ETA",
                "--vis_mono", *NARROW]
        if name == "jax":
            jax_test.save_depth(jax_test.build_test_parser().parse_args(argv),
                                JaxMVS4Net(config), variables, [scan])
        else:
            port_test.main(argv + ["--device", "cpu", "--conf", "0.3", "--thres_view", "1"])
        out[name] = {
            os.path.relpath(os.path.join(d, f), outdir): np.load(os.path.join(d, f))
            for kind in ("vis_ETA", "vis_mono")
            for d, _, fs in os.walk(os.path.join(outdir, scan, kind)) for f in fs}
    return out


def test_vis_dumps_match_the_jax_tool(dumps):
    want, got = dumps["jax"], dumps["port"]
    assert sorted(got) == sorted(want)
    assert len(want) == 3 * 5  # 3 views: 4 stages of attention and one feature map
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape)
        if "vis_mono" in path:
            assert g.shape == (1, 128, 128, 4)  # the last view, stage 4 at full size
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=path)
        else:
            assert g.shape[:2] == (2, 1), path  # (V-1, B, D, h, w)
            close = np.isclose(g, w, rtol=0, atol=1e-4)
            assert close.mean() >= 0.99, (path, close.mean())
