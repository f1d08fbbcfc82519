"""One train step of the port's model variants against the JAX package's.

Three combined configurations cover the variants in training, each
dtu_default() (mono on) at 64x64, 3 views, batch 2 (two textured planes)
from the same perturbed weights (_torch_parity.train_step_pair),
l1ot_lw (1, 1) so the mono decoder's L1 enters the loss:
  - reg3d_asff: Reg3d, the learned positional encoding, ASFF and the
    ConvNeXt pyramid;
  - pdam_dcn: Reg2d with PDAM blocks, DCN heads, the sine encoding and
    the ConvNeXt4 pyramid;
  - cam: Reg2d with CAM blocks
(this file runs reg3d_asff, tests/test_torch_variants_train_attention.py
the other two, so that two test processes share them).
DCAM and PAM, which one configuration cannot hold beside PDAM and CAM,
are held in train mode, gradients included, block by block
(tests/test_torch_variants.py).

Tolerances: the loss and every scalar at rtol 1e-4 (the attention blocks,
ASFF and the ConvNeXt pyramids make larger cost volumes than dtu_default's
FPN4 and Reg2d, and float32 rounding moves the stage losses up to ~2e-5);
the running statistics at atol 1e-5 and rtol 1e-5, and Adam's update,
after the step (check_after).

Gradients: at 64x64 both packages' float32 gradients of these models lie
up to ~1e-2 (relative L2) from the float64 gradient in some tensors, and
up to ~1e-1 in stage 4's PDAM gate bias, whose gradient is ~1e-4 in
norm: float32 rounding moves pre-activations within rounding of a ReLU's
kink to its other side, in either package (measured, one configuration
at a time: the port's float32 gradient lies 2e-2 from its float64 one
with DCN alone, JAX's 3e-2 from it with PDAM alone; a float64 step of
the port on its float32 step's branches comes within 5e-4 of its float32
gradient).
So the port is held to its own float64 step on the ReLU branches of its
float32 step (train_step_pair's branch_grads: the exact gradient of the
piecewise-linear function that the float32 step differentiated), each
tensor within relative L2 2e-3; and JAX's float32 gradient to the nearer
of the port's two float64 gradients, the median over tensors within 2e-4
(measured 4e-5 to 7e-5) and each tensor within 0.15
(_torch_parity.check_variant_grads).
"""

import dataclasses

import pytest

from _torch_parity import check_after, check_scalars, check_variant_grads, train_step_pair
from mvster_tpu_torch.config import MVS4NetConfig

CONFIGS = {
    "reg3d_asff": dict(reg_net="reg3d", pos_enc=2, asff=True, arch_mode="convnext"),
}


def variant_step(name, configs):
    config = dataclasses.asdict(MVS4NetConfig.dtu_default(**configs[name]))
    return train_step_pair(l1ot_lw=(1.0, 1.0), config=config, branch=True)


@pytest.fixture(scope="module", params=list(CONFIGS))
def step(request):
    return variant_step(request.param, CONFIGS)


def test_variant_loss_and_scalars_match_jax(step):
    check_scalars(step, rtol=1e-4)


def test_variant_gradients_match_jax(step):
    check_variant_grads(step)


def test_variant_batch_stats_and_adam_params_match_jax(step):
    check_after(step, stats_rtol=1e-5)
