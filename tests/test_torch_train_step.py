"""One train step of the port against the JAX package's, the published loss weighting.

dtu_default() (mono on) at 64x64, 3 views, batch 2 (two textured planes),
from the same perturbed weights (_torch_parity.train_step_pair), l1ot_lw =
(0, 1).  Tolerances, as _torch_parity's check_* functions state them:
  - the loss and every aux scalar at rtol 1e-5;
  - each gradient tensor (JAX's exported by state-dict key through the
    port's tools/convert.py) at relative L2 <= 1e-4 from JAX's where
    float32 allows it: the backward through stage 4's Reg2d at this size
    puts both packages' float32 gradients up to ~1e-2 from the float64
    gradient, so the port's step also runs in float64 and each tensor is
    held to the float32 noise that this measures (check_grads);
  - BatchNorm running statistics after the step (flax's update, biased
    variance) at atol 1e-5;
  - parameters after one Adam step: Adam's formula on the port's own
    gradients, and JAX's parameters at atol 1e-6 wherever |g| >= 1e-6 and
    the gradients agree to 10%.
With this weighting the mono L1 is weighted 0, so the decoder's gradients
are exactly zero in both packages; test_torch_train_step_mono.py repeats
the step with l1ot_lw = (1, 1).
"""

import numpy as np
import pytest

from _torch_parity import check_after, check_grads, check_scalars, train_step_pair


@pytest.fixture(scope="module")
def step():
    return train_step_pair(l1ot_lw=(0.0, 1.0))


def test_loss_and_aux_scalars_match_jax(step):
    check_scalars(step)


def test_gradients_match_jax(step):
    check_grads(step, mono_zero=True)


def test_batch_stats_and_adam_params_match_jax(step):
    check_after(step)
    # the step moved the running statistics (flax momentum 0.9)
    key = "feature.conv0.0.bn.running_var"
    assert not np.allclose(step["port_after"][key], step["before"][key])
