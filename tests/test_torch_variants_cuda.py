"""The model variants on the card (marked `cuda`; they skip without one).

Each variant of _torch_parity.VARIANTS at 128x192 with 3 views:
  - the eval forward on the card (K1, cuDNN with TF32 off) against the
    same model on the CPU (the kernels' plain versions), with 4 K1
    launches (and 4 K7, one a DCN head, with dcn), by the stage
    comparator; bfloat16 by assert_bf16_close, tests/test_bf16.py's
    criteria for two bf16 forwards (the card's convolutions round
    otherwise than the CPU's);
  - one train step (mono on, batch 2, --ot_backend pallas, Adam) on two
    textured planes: a finite loss, every parameter with a gradient
    moved, and each kernel's launches (K2 and K3 a stage and source, K4
    and K5 a stage, K7 a head in the forward, no K1).
The file imports no JAX, so it runs on a machine without it:
`python -m pytest --noconftest -m cuda tests/test_torch_variants_cuda.py`.
"""

import copy

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    VARIANTS,
    assert_bf16_close,
    assert_stage_close,
    cuda_device,
    launches,
    plane_batch,
    reset_launches,
    t,
    to_numpy_tree,
    torch_batch,
)
from helpers import synthetic_sample
from mvster_tpu_torch.dist.train_step import make_train_step
from mvster_tpu_torch.models.losses import mvs4net_loss
from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
from mvster_tpu_torch.tools.weights import init_state_dict, random_state_dict


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
        reset_launches()
        got = run(card, cuda_device)
        counts = launches()
        assert (counts["K1"], counts["K7"]) == (4, 4 if VARIANTS[name].get("dcn") else 0)
        want = run(model, "cpu")
    if name == "bf16":
        assert_bf16_close(want, got)
    else:
        assert_stage_close(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_train_step_on_the_card(cuda_device, name):
    model = MVS4Net(MVS4NetConfig.dtu_default(**VARIANTS[name]))
    model.load_state_dict(init_state_dict(model, seed=21), strict=True)
    model.to(cuda_device)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), mvs4net_loss,
                           dict(inverse_depth=True, ot_iter=10, mono=True, ot_backend="pallas"))
    batch = torch_batch(plane_batch(2, h=128, w=192), cuda_device)
    reset_launches()
    scalars, _ = step(batch)
    torch.cuda.synchronize()
    per_step = 4 * 2  # 4 stages x 2 source views
    got = {k: v for k, v in launches().items() if k != "K6"}
    assert got == dict(K1=0, K2=per_step, K3=per_step, K4=4, K5=4,
                       K7=4 if VARIANTS[name].get("dcn") else 0)
    assert np.isfinite(float(scalars["loss"]))
    graded = {k for k, p in model.named_parameters() if p.grad is not None and p.grad.any()}
    moved = {k for k, p in model.named_parameters() if not torch.equal(p.detach(), before[k])}
    assert graded and moved == graded
