"""The port's inference tool against the JAX inference tool, on the CPU.

Both inference tools run the general_eval path over the synthetic scan of
scripts/smoke_test_cli.write_scan (textured plane, 128x128, 3 views) with
the same random weights: the JAX inference tool's save_depth from flax variables,
the port's tools.test.main from the same weights saved as a reference-style
checkpoint.  Their depth and confidence PFMs, cams and images must agree.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from _torch_parity import jax_variables
from helpers import synthetic_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN_ARGS = ["--dataset", "general_eval", "--num_view", "3", "--max_h", "128",
             "--max_w", "128", "--group_cor", "--inverse_depth", "--attn_temp", "2"]


def _write_scan(root):
    spec = importlib.util.spec_from_file_location(
        "smoke_test_cli", os.path.join(REPO, "scripts", "smoke_test_cli.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_scan(str(root))


@pytest.fixture(scope="module")
def both_outputs(tmp_path_factory):
    from mvster_tpu.data.pfm import read_pfm
    from mvster_tpu.models import MVS4Net as JaxMVS4Net
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu.tools import test as jax_test
    from mvster_tpu_torch.tools import test as port_test
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    root = tmp_path_factory.mktemp("scan")
    scan = _write_scan(root)
    config = JaxConfig.dtu_default(mono=False)
    variables = jax_variables(config, synthetic_sample(0, nviews=3, h=128, w=128), 0)
    ckpt = root / "model.ckpt"
    torch.save({"model": state_dict_from_jax(variables)}, ckpt)

    outs = {}
    for name in ("jax", "port"):
        outdir = str(root / name)
        argv = ["--testpath", str(root), "--testlist", scan, "--loadckpt",
                str(ckpt), "--outdir", outdir, *SCAN_ARGS]
        if name == "jax":
            args = jax_test.build_test_parser().parse_args(argv)
            jax_test.save_depth(args, JaxMVS4Net(config), variables, [scan])
        else:
            port_test.main(argv + ["--device", "cpu"])
        outs[name] = {
            kind: [read_pfm(os.path.join(outdir, scan, kind, f"{v:08d}.pfm"))[0]
                   for v in range(3)]
            for kind in ("depth_est", "confidence")
        }
        outs[name]["dir"] = os.path.join(outdir, scan)
    return outs


def test_depth_maps_match_jax(both_outputs):
    jax_out, port_out = both_outputs["jax"], both_outputs["port"]
    for v in range(3):
        want, got = jax_out["depth_est"][v], port_out["depth_est"][v]
        assert got.shape == want.shape == (128, 128)
        assert np.isfinite(got).all() and got.min() > 0
        # argmax flips at near-ties move a pixel by a hypothesis bin; they
        # must stay rare (the model tests bound them stage by stage)
        same = np.isclose(got, want, rtol=1e-4)
        assert same.mean() >= 0.99, f"view {v}: {same.mean():.2%} of depths agree"
        np.testing.assert_allclose(port_out["confidence"][v][same],
                                   jax_out["confidence"][v][same], atol=2e-3)


def test_writes_the_jax_layout(both_outputs):
    jax_dir, port_dir = both_outputs["jax"]["dir"], both_outputs["port"]["dir"]
    for v in range(3):
        for rel in (f"cams/{v:08d}_cam.txt", f"images/{v:08d}.jpg"):
            with open(os.path.join(jax_dir, rel), "rb") as f:
                want = f.read()
            with open(os.path.join(port_dir, rel), "rb") as f:
                assert f.read() == want, rel


def test_infer_views_pads_the_last_chunk():
    """eval_batch 2 over 3 views (last chunk padded) gives eval_batch 1's maps."""
    from helpers import plane_scene_sample
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.test import infer_views
    from mvster_tpu_torch.tools.weights import random_state_dict

    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False)).eval()
    model.load_state_dict(random_state_dict(model, seed=0), strict=True)
    views = []
    for seed in range(3):
        s = plane_scene_sample(seed)
        views.append({"imgs": s["imgs"][0], "depth_values": s["depth_values"][0],
                      "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()}})
    one = list(infer_views(model, views, eval_batch=1))
    two = list(infer_views(model, views, eval_batch=2))
    assert [r["chunk_views"] for _, r in two] == [2, 2, 1]
    for (s1, r1), (s2, r2) in zip(one, two):
        assert s1 is s2
        assert r1["depth"].shape == r2["depth"].shape == (1, 64, 64)
        same = np.isclose(r1["depth"], r2["depth"], rtol=1e-4)
        assert same.mean() >= 0.99
        np.testing.assert_allclose(r1["confidence"][same], r2["confidence"][same],
                                   atol=1e-4)
