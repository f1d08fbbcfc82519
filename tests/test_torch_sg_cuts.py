"""The sg_cuts measurement hook (MVS4NetConfig.sg_cuts) in the port against the JAX package's.

One train step of dtu_default() (mono on) at 64x64, 3 views, batch 2 (two
textured planes) in both packages from the same perturbed weights
(_torch_parity.train_step_pair), under each cut and under none.  The loss
weighs the mono decoder's L1 by 0.5 beside the OT term (tests/test_sg_cuts.py's
l1ot_lw, so that the mono path reaches the backbone past the other cuts);
the "cost_volume" case takes the published pure-OT weights (0, 1), so that
the backbone lies wholly upstream of its cut.  Each case checks:
  - the forward (train mode) is bitwise the uncut one;
  - every parameter upstream of the cut gets exactly zero gradient, in both
    packages: "fpn" the backbone, "mono" the mono decoder, "logits" Reg2d,
    "cost_volume" the backbone (and the mono decoder, weighed 0);
  - the other gradients equal JAX's by check_variant_grads' criteria (the
    port within 2e-3 of its float64 step on its own ReLU branches, JAX's
    within 0.15 of the port's float64 gradients, 2e-4 in the median);
  - the source-feature gradient (scatter_grad, K3 on a card; counted here
    by a stub around its plain version) runs only where a gradient reaches
    the warped source features: without a cut and under "mono".  Under
    "warp" it is never reached, while the backbone still gets gradient
    through the reference features and the mono decoder.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (
    check_scalars,
    check_variant_grads,
    plane_batch,
    to_numpy_tree,
    torch_batch,
    train_step_pair,
)
from mvster_tpu_torch.config import MVS4NetConfig
from mvster_tpu_torch.kernels import warp_vjp
from mvster_tpu_torch.models.mvs4net import MVS4Net
from mvster_tpu_torch.tools.weights import random_state_dict

# cut -> (l1ot_lw, the state-dict prefixes wholly upstream of the cut)
CUTS = {
    "none": ((0.5, 1.0), ()),
    "fpn": ((0.5, 1.0), ("feature.",)),
    "mono": ((0.5, 1.0), ("mono_depth_decoder.",)),
    "warp": ((0.5, 1.0), ()),
    "cost_volume": ((0.0, 1.0), ("feature.", "mono_depth_decoder.")),
    "logits": ((0.5, 1.0), ("reg.",)),
}


def _cuts(name):
    return () if name == "none" else (name,)


@pytest.fixture(scope="module", params=list(CUTS))
def case(request):
    """(name, the train step pair, scatter_grad calls in the port's steps)."""
    name = request.param
    calls = []
    scatter = warp_vjp.scatter_grad

    def counted(*args, **kwargs):
        calls.append(1)
        return scatter(*args, **kwargs)

    config = dataclasses.asdict(MVS4NetConfig.dtu_default(sg_cuts=_cuts(name)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(warp_vjp, "scatter_grad", counted)
        step = train_step_pair(l1ot_lw=CUTS[name][0], config=config, branch=True)
    return name, step, len(calls)


def test_forward_is_unchanged_by_the_cut(case):
    name = case[0]
    batch = torch_batch(plane_batch(2))
    outs = []
    for cuts in ((), _cuts(name)):
        model = MVS4Net(MVS4NetConfig.dtu_default(sg_cuts=cuts))
        model.load_state_dict(random_state_dict(model, 0), strict=True)
        model.train()
        outs.append(to_numpy_tree(copy.deepcopy(model)(
            batch["imgs"], batch["proj_matrices"], batch["depth_values"])))

    def leaves(tree, path=""):
        for k, v in tree.items():
            yield from (leaves(v, f"{path}{k}.") if isinstance(v, dict)
                        else [(f"{path}{k}", v)])

    want = dict(leaves(outs[0]))
    got = dict(leaves(outs[1]))
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_gradients_upstream_of_the_cut_are_zero(case):
    name, step, _ = case
    upstream = [k for k in step["port_grads"] if k.startswith(CUTS[name][1])]
    assert bool(upstream) == bool(CUTS[name][1])
    for key in upstream:
        assert not np.any(step["port_grads"][key]), key
        assert not np.any(step["jax_grads"][key]), key
    # the rest still learns
    assert any(np.any(g) for k, g in step["port_grads"].items() if k not in upstream)


def test_loss_and_gradients_match_jax(case):
    _, step, _ = case
    check_scalars(step, rtol=1e-4)
    check_variant_grads(step)


def test_warp_cut_never_reaches_the_source_gradient(case):
    name, step, calls = case
    # three port steps (float32, and float64 twice), 4 stages x 2 sources
    assert calls == (3 * 4 * 2 if name in ("none", "mono") else 0)
    if name == "warp":  # the backbone still learns through the reference and mono
        assert any(np.any(g) for k, g in step["port_grads"].items()
                   if k.startswith("feature."))
