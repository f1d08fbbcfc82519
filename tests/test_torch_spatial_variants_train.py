"""The image-row sharded train step (dist/spatial.make_spatial_train_step) of every model variant.

Each variant of tests/test_torch_spatial_variants.py (Reg3d, CAM, DCAM,
PAM, PDAM, ASFF, ConvNeXt, ConvNeXt4 and DCN) as spatial 2 on two gloo
ranks on the CPU, spawned once for the file (the module fixture `runs`
starts them, computes the references while they run, then reads their
results); each rank is this file run as a script with torchrun's
environment.  tests/test_torch_spatial_train.py's configuration: the
narrow model (fpn_base_channel 4, reg_channel 4, group_cor_dim 4; ASFF
at fpn_base_channel 8) with the mono branch on, at H = 128, W = 64, 2
views, batch 2 (two textured planes, sample 1's masks without their top
quarter of rows), 3 Sinkhorn iterations with the mono L1 weighed in, one
SGD step (lr 1e-3), in float64 with the `xla` loss, from perturbed flax
variables through tools/weights.py.

The reference is the port's one-process float64 step (make_train_step)
on the whole batch; each variant's one-process step is held against the
JAX package's by tests/test_torch_variants_train.py and
tests/test_torch_variants_train_attention.py.  Tolerances are the
float64 bound of tests/test_torch_spatial_train.py: every gradient and
every parameter and running statistic after the step within relative L2
F64_RTOL of one process's, the scalars at rtol 1e-6 (the Sinkhorn runs in
float32 in both steps), and the two ranks' parameters bitwise equal.
Measured: gradients within 3.0e-9 (PAM; the others 1.3e-12 to 4.2e-12),
parameters and statistics within 5.8e-13, scalars within 1.9e-7.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from _torch_parity import BAND_VARIANTS, spawn_ranks, wait_ranks

CFG = dict(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
           fpn_base_channel=4, reg_channel=4, attn_temp=2.0, mono=True)
H, W, VIEWS, BATCH = 128, 64, 2, 2
LOSS_KW = dict(inverse_depth=True, ot_iter=3, mono=True, l1ot_lw=(1.0, 1.0), ot_backend="xla")
LR = 1e-3
F64_RTOL = 1e-7


def _batch():
    from _torch_parity import plane_batch

    b = plane_batch(BATCH, h=H, w=W)
    b["imgs"] = b["imgs"][:, :VIEWS]
    b["proj_matrices"] = {k: v[:, :VIEWS] for k, v in b["proj_matrices"].items()}
    for m in b["mask"].values():
        m[1, : m.shape[1] // 4] = 0.0
    return b


def _f64(batch):
    if isinstance(batch, dict):
        return {k: _f64(v) for k, v in batch.items()}
    return torch.from_numpy(np.asarray(batch, np.float64))


def _model(sd, overrides):
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

    model = MVS4Net(MVS4NetConfig(**dict(CFG, **overrides)))
    model.load_state_dict(sd, strict=True)
    return model.double()


def _result(model, scalars):
    return {"scalars": {k: float(v) for k, v in scalars.items()},
            "grads": {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
                      for k, p in model.named_parameters()},
            "after": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


# ---------------------------------------------------------------- the ranks

def _worker(tmp):
    import torch.distributed as dist

    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed
    from mvster_tpu_torch.dist.spatial import make_2d_groups, make_spatial_train_step

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank, _ = maybe_initialize_distributed("cpu")
    groups = make_2d_groups(1, 2)
    out = {}
    for name, overrides in BAND_VARIANTS.items():
        model = _model(inputs["sd"][name], overrides)
        step = make_spatial_train_step(model, torch.optim.SGD(model.parameters(), lr=LR),
                                       groups, loss_kwargs=LOSS_KW)
        scalars, _ = step(_f64(inputs["batch"]))
        out[name] = _result(model, scalars)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------- the references

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _torch_parity import jax_train_variables
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu_torch.dist.train_step import make_train_step
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    tmp = str(tmp_path_factory.mktemp("spatial_variants_train"))
    batch = _batch()
    sds = {name: state_dict_from_jax(jax_train_variables(JaxConfig(**dict(CFG, **o)), batch, seed=0))
           for name, o in BAND_VARIANTS.items()}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"sd": sds, "batch": batch}, f)
    procs = spawn_ranks(__file__, [tmp], 2)
    try:
        single = {}
        for name, o in BAND_VARIANTS.items():
            model = _model(sds[name], o)
            step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR),
                                   loss_kwargs=LOSS_KW)
            scalars, _ = step(_f64(batch))
            single[name] = _result(model, scalars)
    finally:
        wait_ranks(procs)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"single": single, "ranks": ranks}


@pytest.mark.parametrize("name", list(BAND_VARIANTS))
def test_variant_float64_step_equals_the_single_process_step(runs, name):
    from _torch_parity import GRAD_NOISE, relative_l2

    want = runs["single"][name]
    first = runs["ranks"][0][name]
    for rank in runs["ranks"]:
        got = rank[name]
        for key, g in want["grads"].items():
            if np.linalg.norm(g) < GRAD_NOISE:  # zero in exact arithmetic
                np.testing.assert_allclose(got["grads"][key], g, atol=1e-12, err_msg=key)
                continue
            assert relative_l2(got["grads"][key], g) <= F64_RTOL, (
                key, relative_l2(got["grads"][key], g))
        for key, v in want["after"].items():
            if key.endswith("num_batches_tracked"):
                assert got["after"][key] == v, key
            else:
                assert relative_l2(got["after"][key], v) <= F64_RTOL, (
                    key, relative_l2(got["after"][key], v))
        for key, v in want["scalars"].items():
            np.testing.assert_allclose(got["scalars"][key], v, rtol=1e-6, atol=1e-12,
                                       err_msg=key)
        assert got["scalars"] == first["scalars"]
        for key, v in first["after"].items():
            np.testing.assert_array_equal(got["after"][key], v, err_msg=key)


if __name__ == "__main__":
    _worker(sys.argv[1])
