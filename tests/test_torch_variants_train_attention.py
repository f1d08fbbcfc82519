"""One train step of the attention-block variants against the JAX package's.

The configurations pdam_dcn (Reg2d with PDAM blocks, DCN heads, the sine
encoding and the ConvNeXt4 pyramid) and cam (Reg2d with CAM blocks) of
tests/test_torch_variants_train.py, which states the setup and the
tolerances; split from it so that two test processes share the steps.
"""

import pytest

from _torch_parity import check_after, check_scalars, check_variant_grads
from test_torch_variants_train import variant_step

CONFIGS = {
    "pdam_dcn": dict(agg_type="ConvBnReLU3D_PDAM", dcn=True, pos_enc=1,
                     arch_mode="convnext4"),
    "cam": dict(agg_type="ConvBnReLU3D_CAM"),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def step(request):
    return variant_step(request.param, CONFIGS)


def test_attention_variant_loss_and_scalars_match_jax(step):
    check_scalars(step, rtol=1e-4)


def test_attention_variant_gradients_match_jax(step):
    check_variant_grads(step)


def test_attention_variant_batch_stats_and_adam_params_match_jax(step):
    check_after(step, stats_rtol=1e-5)
