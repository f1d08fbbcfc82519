"""One train step of the port against the JAX package's, with the mono L1 weighted in.

As test_torch_train_step.py, with l1ot_lw = (1, 1): the mono decoder's
L1 now enters the loss, so its gradients are non-zero and a broken mono
backward shows.  Same tolerances (_torch_parity's check_* functions).
"""

import numpy as np
import pytest

from _torch_parity import check_after, check_grads, check_scalars, train_step_pair


@pytest.fixture(scope="module")
def step():
    return train_step_pair(l1ot_lw=(1.0, 1.0))


def test_loss_and_aux_scalars_match_jax_with_mono_l1(step):
    check_scalars(step)
    assert step["jax_scalars"]["s3_d_loss"] > 0


def test_gradients_match_jax_with_mono_l1(step):
    check_grads(step, mono_zero=False)
    assert np.any(step["port_grads"]["mono_depth_decoder.conv3x3.2.weight"])


def test_batch_stats_and_adam_params_match_jax_with_mono_l1(step):
    check_after(step)
