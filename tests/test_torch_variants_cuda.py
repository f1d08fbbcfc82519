"""The model variants on the card (marked `cuda`; they skip without one).

Each variant of _torch_parity.VARIANTS at 128x192 with 3 views: the eval
forward on the card (K1, cuDNN with TF32 off) against the same model on
the CPU (the kernels' plain versions), with 4 K1 launches, by the stage
comparator; bfloat16 by assert_bf16_close, tests/test_bf16.py's criteria
for two bf16 forwards (the card's convolutions round otherwise than the
CPU's).  The file imports no JAX, so it runs on a machine without it:
`python -m pytest --noconftest -m cuda tests/test_torch_variants_cuda.py`.
"""

import copy

import pytest
import torch

from _torch_parity import (  # noqa: F401
    VARIANTS,
    assert_bf16_close,
    assert_stage_close,
    cuda_device,
    t,
    to_numpy_tree,
)
from helpers import synthetic_sample
from mvster_tpu_torch.kernels import warp_correlate
from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
from mvster_tpu_torch.tools.weights import random_state_dict


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_forward_on_the_card_matches_the_cpu(cuda_device, name):
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False, **VARIANTS[name]))
    model.load_state_dict(random_state_dict(model, seed=21), strict=True)
    model.eval()
    card = copy.deepcopy(model).to(cuda_device)
    sample = synthetic_sample(21, nviews=3, h=128, w=192)

    def run(net, device):
        return to_numpy_tree(net(
            t(sample["imgs"], device),
            {k: t(v, device) for k, v in sample["proj_matrices"].items()},
            t(sample["depth_values"], device)))

    with torch.inference_mode():
        warp_correlate.fused_cost_volume.launches = 0
        got = run(card, cuda_device)
        assert warp_correlate.fused_cost_volume.launches == 4
        want = run(model, "cpu")
    if name == "bf16":
        assert_bf16_close(want, got)
    else:
        assert_stage_close(want, got)
