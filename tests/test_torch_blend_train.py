"""One BlendedMVS fine-tune train step of the port against the JAX package's, through the fused Sinkhorn route.

tests/test_blend_train.py's narrow config (group_cor, group_cor_dim 4,
inverse depth, fpn_base_channel = reg_channel = 4, mono) and its batch
(helpers.synthetic_sample(0): batch 2, 2 views, 64x64), blend_loss with
ot_backend="pallas", 3 Sinkhorn iterations, l1ot_lw (0, 1).  Both steps
start from the same perturbed weights (_torch_parity.train_step_pair); the
JAX step runs under pltpu.force_tpu_interpret_mode(), so its loss goes
through the Pallas Sinkhorn pair (K4/K5) in interpret mode, the port's
through the plain versions of its CUDA pair.

Tolerances: the loss and every scalar (blend_loss's epe, err1, err3
included) at rtol 1e-4.  Gradients by check_grads_by_branch at relative L2
1e-3: JAX's float32 gradient against the port's float64 step (4.4e-4 at
most), the port's against its float64 step on the ReLU branches
of its float32 step (9.8e-5 at most).  The port's float32 step here puts
one pre-activation of stage 4's first Reg2d layer on the other side of 0
(it lies within float32 rounding of 0), which alone moves the FPN's and
that layer's float32 gradients ~1e-2 from float64; with other weight
seeds JAX's float32 step does the same, so check_grads, which holds both
packages to one float64 branch, cannot be used here.
"""

import pytest

from _torch_parity import check_grads_by_branch, check_scalars, train_step_pair
from helpers import synthetic_sample

NARROW = dict(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
              fpn_base_channel=4, reg_channel=4, mono=True)


@pytest.fixture(scope="module")
def step():
    return train_step_pair(
        l1ot_lw=(0.0, 1.0), config=NARROW, loss="blend_loss", interpret=True, branch=True,
        batch=synthetic_sample(0, batch=2, nviews=2, h=64, w=64, with_gt=True),
        loss_kwargs=dict(inverse_depth=True, ot_iter=3, mono=True, ot_backend="pallas"))


def test_blend_loss_and_scalars_match_jax(step):
    assert {"epe", "err1", "err3"} <= step["port_scalars"].keys()
    check_scalars(step, rtol=1e-4)


def test_blend_gradients_match_jax(step):
    check_grads_by_branch(step)
