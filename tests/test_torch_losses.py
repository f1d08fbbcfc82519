"""The port's Sinkhorn, losses, metrics and schedules against the JAX package.

Inputs from numpy seeds.  Tolerances: sinkhorn loss (both modes) and the
mvs4net_loss / blend_loss scalars at rtol 1e-5, the transport plan at
atol 1e-6; the loss's gradient with respect to attn_weight at rtol 1e-4
(atol 1e-7); ot_backend "pallas" against "xla" at the loss's rtol 1e-5 and
the gradient's rtol 2e-4 / atol 5e-7; depth metrics at rtol 1e-6; schedules against optax at steps
0, 499, 500, the milestones and the end, at rtol 1e-5 and atol 1e-7 of the
base rate (optax evaluates them in float32, where the cosine's tail near
zero loses its relative digits).
"""

import numpy as np
import pytest
import torch

from _torch_parity import t
from mvster_tpu_torch.core.sinkhorn import sinkhorn
from mvster_tpu_torch.models import losses
from mvster_tpu_torch.train import metrics, schedules


def _ot_inputs(seed, b=2, d=8, h=8, w=8, gain=3.0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, d, h, w)) * gain
    attn = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    inv = 1.0 / 935.0 + (1.0 / 425.0 - 1.0 / 935.0) * np.arange(d) / (d - 1)
    hypo = (1.0 / inv)[None, :, None, None] * rng.uniform(0.98, 1.02, size=(b, d, h, w))
    gt = rng.uniform(440, 920, size=(b, h, w))
    mask = rng.uniform(size=(b, h, w)) > 0.2
    return [x.astype(np.float32) for x in (gt, hypo, attn)] + [mask]


@pytest.mark.parametrize("continuous", [False, True])
def test_sinkhorn_matches_jax(continuous):
    import jax
    import jax.numpy as jnp

    from mvster_tpu.core.sinkhorn import sinkhorn as jax_sinkhorn

    gt, hypo, attn, mask = _ot_inputs(0)
    want_t, want_loss = jax_sinkhorn(jnp.asarray(gt), jnp.asarray(hypo), jnp.asarray(attn),
                                     jnp.asarray(mask), iters=10, continuous=continuous)
    want_grad = jax.grad(lambda a: jax_sinkhorn(
        jnp.asarray(gt), jnp.asarray(hypo), a, jnp.asarray(mask), iters=10,
        continuous=continuous)[1])(jnp.asarray(attn))

    a = t(attn).requires_grad_()
    got_t, got_loss = sinkhorn(t(gt), t(hypo), a, torch.from_numpy(mask), iters=10,
                               continuous=continuous)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t), atol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)


def test_sinkhorn_gt_bin_takes_the_first_nearest_hypothesis():
    # two hypotheses equally near the GT: both packages pick the first
    hypo = np.array([500.0, 520.0, 540.0, 560.0], np.float32)[None, :, None, None]
    gt = np.full((1, 1, 1), 530.0, np.float32)
    attn = np.full((1, 4, 1, 1), 0.25, np.float32)
    mask = np.ones((1, 1, 1), bool)
    t_map, _ = sinkhorn(t(gt), t(hypo), t(attn), torch.from_numpy(mask), iters=10)
    # all GT mass in column 1 (520), none in column 2 (540)
    cols = t_map[0, 0].sum(dim=0)
    assert cols[1] > 0.99 and cols[2] < 1e-6


def _loss_outputs(seed, b=2, h=16, w=16, mono=True):
    """A 4-stage output dict with the losses' inputs, and its GT."""
    rng = np.random.default_rng(seed)
    outputs, depth, mask = {}, {}, {}
    for s, (sc, d) in enumerate(zip([8, 4, 2, 1], [8, 8, 4, 4]), start=1):
        gt, hypo, attn, m = _ot_inputs(seed + s, b, d, h // sc, w // sc)
        out = {"hypo_depth": hypo, "attn_weight": attn,
               "depth": np.take_along_axis(hypo, attn.argmax(1)[:, None], 1)[:, 0]}
        if mono and s > 1:
            out["mono_depth"] = rng.uniform(440, 920, size=gt.shape).astype(np.float32)
        outputs[f"stage{s}"] = out
        depth[f"stage{s}"], mask[f"stage{s}"] = gt, m.astype(np.float32)
    outputs.update(outputs["stage4"])
    dv = np.array([[425.0, 935.0]] * b, np.float32)
    return outputs, depth, mask, dv


@pytest.mark.parametrize("fn_name,kw", [
    ("mvs4net_loss", dict(inverse_depth=True, mono=True)),
    ("mvs4net_loss", dict(inverse_depth=False, mono=True, l1ot_lw=(1.0, 1.0),
                          stage_lw=(0.5, 1.0, 1.0, 2.0))),
    ("mvs4net_loss", dict(inverse_depth=True, ot_continous=True, ot_iter=4)),
    ("blend_loss", dict(inverse_depth=True, mono=True, l1ot_lw=(1.0, 1.0))),
])
def test_losses_match_jax(fn_name, kw):
    import jax
    import jax.numpy as jnp

    from mvster_tpu.models import losses as jax_losses

    outputs, depth, mask, dv = _loss_outputs(1)
    jnp_tree = lambda x: jax.tree_util.tree_map(jnp.asarray, x)  # noqa: E731
    want, want_aux = getattr(jax_losses, fn_name)(
        jnp_tree(outputs), jnp_tree(depth), jnp_tree(mask), depth_values=jnp.asarray(dv), **kw)

    def tt(x):
        return {k: tt(v) for k, v in x.items()} if isinstance(x, dict) else t(x)

    got, got_aux = getattr(losses, fn_name)(tt(outputs), tt(depth), tt(mask),
                                            depth_values=t(dv), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert got_aux.keys() == want_aux.keys()
    for key, want_v in want_aux.items():
        got_v = got_aux[key] if isinstance(want_v, list) else [got_aux[key]]
        want_v = want_v if isinstance(want_v, list) else [want_v]
        np.testing.assert_allclose([float(x) for x in got_v], [float(x) for x in want_v],
                                   rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("ot_iter,ot_eps", [(6, 1.0), (10, 1.0)])
def test_pallas_ot_backend_matches_xla(ot_iter, ot_eps):
    """ot_backend="pallas" (the fused K4/K5 route, plain on the CPU) gives
    the xla backend's loss at rtol 1e-5 and its attn_weight gradients at
    rtol 2e-4 / atol 5e-7, the JAX package's tolerances for the same test
    (tests/test_pallas_sinkhorn.py)."""
    outputs, depth, mask, dv = _loss_outputs(2, h=32, w=32, mono=False)
    stages = [k for k in outputs if k.startswith("stage")]

    def tt(x):
        return {k: tt(v) for k, v in x.items()} if isinstance(x, dict) else t(x)

    runs = {}
    for backend in ("xla", "pallas"):
        outs = tt({k: v for k, v in outputs.items() if k in stages})
        for k in stages:
            outs[k]["attn_weight"].requires_grad_()
        outs.update(outs["stage4"])
        total, _ = losses.mvs4net_loss(outs, tt(depth), tt(mask), ot_iter=ot_iter,
                                       ot_eps=ot_eps, ot_backend=backend)
        total.backward()
        runs[backend] = (float(total.detach()),
                         {k: outs[k]["attn_weight"].grad.numpy() for k in stages})
    np.testing.assert_allclose(runs["pallas"][0], runs["xla"][0], rtol=1e-5)
    for k in stages:
        np.testing.assert_allclose(runs["pallas"][1][k], runs["xla"][1][k],
                                   rtol=2e-4, atol=5e-7, err_msg=k)


def test_depth_metrics_match_jax():
    import jax.numpy as jnp

    from mvster_tpu.train.metrics import depth_metrics as jax_metrics

    rng = np.random.default_rng(3)
    est = rng.uniform(440, 920, size=(3, 16, 16)).astype(np.float32)
    gt = (est + rng.normal(0, 4, size=est.shape)).astype(np.float32)
    mask = rng.uniform(size=est.shape) > 0.3
    mask[2] = False  # an image with no valid pixel leaves the mean
    want = jax_metrics(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask))
    got = metrics.depth_metrics(t(est), t(gt), torch.from_numpy(mask))
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)
    meter = metrics.DictAverageMeter()
    meter.update({"a": 1.0})
    meter.update({"a": torch.tensor(3.0)})
    assert meter.mean() == {"a": 2.0}
    assert metrics.tree_to_float({"x": [torch.tensor(1.5)], "y": torch.ones(2)}) == {
        "x": [1.5], "y": [1.0, 1.0]}


@pytest.mark.parametrize("name", ["MS", "cos", "onecycle"])
def test_schedules_match_optax(name):
    from mvster_tpu.train.schedules import make_lr_schedule

    base_lr, steps_per_epoch, epochs = 1e-3, 120, 10
    want = make_lr_schedule(name, base_lr, steps_per_epoch, epochs, "6,8,9:2")
    factor = schedules.make_lr_factor(name, steps_per_epoch, epochs, "6,8,9:2")
    steps = [0, 1, 359, 360, 361, 499, 500, 719, 720, 959, 960, 1079, 1080, 1199, 1200]
    for step in steps:
        np.testing.assert_allclose(base_lr * factor(step), float(want(step)), rtol=1e-5,
                                   atol=1e-7 * base_lr, err_msg=f"{name} step {step}")


def test_lambda_lr_gives_the_step_zero_rate_to_the_first_update():
    param = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([param], lr=0.3)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, schedules.make_lr_factor("MS", 100, 10, "6,8,9:2"))
    assert opt.param_groups[0]["lr"] == pytest.approx(0.1)  # base_lr * warmup 1/3
    opt.step()
    sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(0.3 * (1 / 3 * (1 - 1 / 500) + 1 / 500))
