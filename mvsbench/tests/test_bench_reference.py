"""The plain reference against the port's CPU path at a small size, on the
benchmark's seeded weights (the only benchmark file that imports the port
beside the drivers)."""

import json
import os

import numpy as np
import pytest
import torch

from mvsbench import traffic, weights
from mvsbench.cells import HERE, reference_of
from mvsbench.check import serve_inputs, train_batch
from mvsbench.reference import losses as ref_losses
from mvsbench.reference import model as ref_model

CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "configs")) if f.endswith(".json"))
SMALL = dict(height=64, width=128, views=3, batch=1, pool=2, depth_range=[425.0, 935.0],
             focal_scale=1.1, max_angle=0.05, max_shift=30.0, gt=True, mask_share=0.8)


def port_model(sd, train):
    from mvster_tpu_torch.config import MVS4NetConfig
    from mvster_tpu_torch.models.mvs4net import MVS4Net

    model = MVS4Net(MVS4NetConfig.dtu_default())
    model.load_state_dict(sd, strict=True)
    return model.train(train)


@pytest.mark.parametrize("config", CONFIGS)
def test_state_shapes_are_the_checkpoint_grammar(config):
    """Each configuration's reference lists the port's state dict, key for
    key, for the model the port builds from the configuration's flags."""
    from mvsbench.drivers import serve

    with open(os.path.join(HERE, "configs", config + ".json")) as f:
        spec = json.load(f)
    ref, cfg = reference_of(spec)
    want = {k: tuple(v.shape) for k, v in serve.port_model(spec).state_dict().items()}
    assert {k: tuple(s) for k, s in ref.state_shapes(cfg).items()} == want


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_eval_cascade_matches_the_port(seed):
    cfg = ref_model.Config()
    sd = weights.seeded_state_dict(ref_model.state_shapes(cfg), seed, "cpu")
    sample = traffic.pool({**SMALL, "gt": False}, seed)[0]
    imgs, projs, dv = serve_inputs(sample, "cpu")
    with torch.no_grad():
        out = port_model(sd, False)(imgs, projs, dv)
        ref, _ = ref_model.forward(sd, cfg, imgs, projs, dv,
                                   stage_depths={k: out[k]["depth"] for k in ("stage1", "stage2", "stage3")})
    for key, r in ref.items():
        # float32 in both, the geometry rounded differently: the sharp
        # stage-4 softmax moves by up to ~1e-3 (float64 reads the same)
        assert torch.equal(out[key]["hypo_depth"], r["hypo"]) or torch.allclose(
            out[key]["hypo_depth"], r["hypo"], rtol=1e-6)
        assert (out[key]["attn_weight"] - r["attn"]).abs().max() < 5e-3
        assert (out[key]["photometric_confidence"] - r["confidence"]).abs().max() < 5e-3


def test_first_train_step_matches_the_port():
    from mvster_tpu_torch.data.loader import _stack_tree
    from mvster_tpu_torch.models.losses import mvs4net_loss

    cfg = ref_model.Config()
    sd = weights.seeded_state_dict(ref_model.state_shapes(cfg), 7, "cpu")
    batch = train_batch(_stack_tree(traffic.pool(SMALL, 5)), "cpu")
    model = port_model(sd, True)
    out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    loss, aux = mvs4net_loss(out, batch["depth"], batch["mask"], inverse_depth=True,
                             ot_iter=10, mono=True)
    loss.backward()
    losses, grads, params, *_ = ref_losses.train_steps(ref_model.forward, sd, cfg, [batch])
    want = [float(loss)] + [float(x) for x in aux["stage_ot_loss"]]
    np.testing.assert_allclose(losses[0], want, rtol=1e-5)
    got = {k: p.grad for k, p in model.named_parameters()}
    norms = {k: float(g.norm()) for k, g in grads.items()}
    median = float(np.median(list(norms.values())))
    for k, g in grads.items():
        # float32 gradient noise through the last stage's Reg2d: ~1e-2 a value
        assert abs(float(got[k].norm()) - norms[k]) <= 1e-2 * max(norms[k], median), k
    # one Adam step moves each element by lr / 3 (the warm-up's factor)
    # where its gradient is well above eps
    moved = max(float((params[k] - sd[k]).abs().max()) for k in params)
    assert moved == pytest.approx(1e-3 / 3, rel=5e-3)  # p - p0 rounds at p's ulp


def test_tf32_operands_move_the_cascade():
    cfg = ref_model.Config()
    low = ref_model.Config(lower="tf32")
    sd = weights.seeded_state_dict(ref_model.state_shapes(cfg), 1, "cpu")
    imgs, projs, dv = serve_inputs(traffic.pool({**SMALL, "gt": False}, 1)[0], "cpu")
    with torch.no_grad():
        a, _ = ref_model.forward(sd, cfg, imgs, projs, dv)
        b, _ = ref_model.forward(sd, low, imgs, projs, dv)
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, -3.0])
    assert ref_model.tf32(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, -3.0]
    assert (a["stage1"]["attn"] - b["stage1"]["attn"]).abs().max() > 1e-4
