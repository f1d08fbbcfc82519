"""Image-row sharded inference (dist/spatial.make_spatial_infer_step) of every model variant.

Each variant of _torch_parity.VARIANTS that is not row-local by nature
(Reg3d, the CAM/DCAM/PAM/PDAM attention blocks, ASFF, the two ConvNeXt
pyramids and DCN) as spatial 2 on two gloo ranks on the CPU, spawned once
for the file (the module fixture `runs` starts them, computes the
references while they run, then reads their results); each rank is this
file run as a script with torchrun's environment.  The configuration is
tests/test_torch_spatial.py's narrow one (fpn_base_channel 4, reg_channel
4, group_cor_dim 4) at H = 128, W = 64, 2 views, batch 2 (two textured
planes, _torch_parity.plane_batch), with each variant's override and its
weights from state_dict_from_jax of perturbed flax variables
(_torch_parity.BAND_VARIANTS: ASFF at fpn_base_channel 8).

At H = 128 a band of stage 1 holds 8 rows, so Reg2d's deepest level (its
conv6, where the attention blocks sit) holds one row a band: PAM's 7x7 and
PDAM's 7x7x7 gates take 3-row halos from a band of one row and the
image's edge, and CAM's and DCAM's pools span both bands.

The reference is the port's single-process eval forward on the whole
batch, itself held against the JAX package for every variant by
tests/test_torch_variants_model.py.  Both run in float64 (the model and
its inputs; the cost volume takes K1's plain version on the CPU): in
float32 a band's convs sum in another order than the whole image's, and
at these widths Reg2d and the decisive softmax amplify that past the
stage comparator's atol at a few stage-4 pixels (measured: PAM 3.8e-3 at
8 of 65536 attention values, ConvNeXt4 2.6e-2 at 2), where in float64
every variant's attention lies within 1.7e-11 of one process's (measured:
ConvNeXt4 1.6e-11, the others 2.4e-13 to 5.4e-12).  Held by
the stage comparator (_torch_parity.assert_stage_close, attention atol
2e-3), every stage's hypotheses at rtol 1e-5 (no window moves), as in
tests/test_torch_spatial.py, and every stage's attention at atol 1e-10.
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
           fpn_base_channel=4, reg_channel=4, attn_temp=2.0)
H, W, VIEWS, BATCH = 128, 64, 2, 2
STAGE_KEYS = ("attn_weight", "hypo_depth", "depth", "photometric_confidence")


def _sample():
    from _torch_parity import plane_batch

    batch = plane_batch(BATCH, h=H, w=W)
    return {"imgs": batch["imgs"][:, :VIEWS], "depth_values": batch["depth_values"],
            "proj_matrices": {k: v[:, :VIEWS] for k, v in batch["proj_matrices"].items()}}


def _inputs(sample):
    f64 = lambda x: torch.from_numpy(np.asarray(x, np.float64))  # noqa: E731
    return (f64(sample["imgs"]), {k: f64(v) for k, v in sample["proj_matrices"].items()},
            f64(sample["depth_values"]))


def _model(sd, overrides):
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

    model = MVS4Net(MVS4NetConfig(**dict(CFG, **overrides)))
    model.load_state_dict(sd, strict=True)
    return model.double().eval()


def _stages(out):
    return {f"stage{s}": {k: out[f"stage{s}"][k].numpy() for k in STAGE_KEYS}
            for s in range(1, 5)}


# ---------------------------------------------------------------- the ranks

def _worker(tmp):
    import torch.distributed as dist

    from mvster_tpu_torch.dist import spatial as sp
    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank, _ = maybe_initialize_distributed("cpu")
    groups = sp.make_2d_groups(1, 2)
    out = {}
    for name, overrides in BAND_VARIANTS.items():
        model = _model(inputs["sd"][name], overrides)
        outs = []
        hook = model.register_forward_hook(lambda mod, args, o: outs.append(o))
        depth, _ = sp.make_spatial_infer_step(model, groups)(*_inputs(inputs["sample"]))
        hook.remove()
        band = _stages(outs[0])
        out[name] = {
            "band_depth": depth.numpy(),
            "gathered": {key: {k: sp.gather_rows(torch.from_numpy(v), groups).numpy()
                               for k, v in st.items()} for key, st in band.items()},
            # a layer with a band of its own keeps none after the step
            "row_bands": [type(m).__name__ for m in model.modules()
                          if getattr(m, "row_band", None) is not None]}
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------- the references

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _torch_parity import jax_variables
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    tmp = str(tmp_path_factory.mktemp("spatial_variants"))
    sample = _sample()
    sds = {name: state_dict_from_jax(jax_variables(JaxConfig(**dict(CFG, **o)), sample, seed=0))
           for name, o in BAND_VARIANTS.items()}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"sd": sds, "sample": sample}, f)
    procs = spawn_ranks(__file__, [tmp], 2)
    try:
        with torch.no_grad():
            single = {name: _stages(_model(sds[name], o)(*_inputs(sample)))
                      for name, o in BAND_VARIANTS.items()}
    finally:
        wait_ranks(procs)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"single": single, "ranks": ranks}


@pytest.mark.parametrize("name", list(BAND_VARIANTS))
def test_variant_spatial_step_matches_the_single_process_forward(runs, name):
    from _torch_parity import assert_stage_close

    want = dict(runs["single"][name], depth=runs["single"][name]["stage4"]["depth"])
    for r, rank in enumerate(runs["ranks"]):
        res = rank[name]
        got = dict(res["gathered"], depth=res["gathered"]["stage4"]["depth"])
        assert_stage_close(want, got)
        for key in ("stage1", "stage2", "stage3", "stage4"):  # no window moved
            np.testing.assert_allclose(got[key]["hypo_depth"], want[key]["hypo_depth"],
                                       rtol=1e-5, err_msg=key)
            np.testing.assert_allclose(got[key]["attn_weight"], want[key]["attn_weight"],
                                       atol=1e-10, err_msg=key)
        assert res["band_depth"].shape == (BATCH, H // 2, W)
        np.testing.assert_array_equal(res["band_depth"],
                                      got["depth"][:, r * H // 2:(r + 1) * H // 2])
        assert res["row_bands"] == []


if __name__ == "__main__":
    _worker(sys.argv[1])
