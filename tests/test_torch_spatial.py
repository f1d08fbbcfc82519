"""Image-row sharded inference (dist/spatial.py) against the port's single-process forward.

Four gloo ranks on the CPU, spawned once for the file (the module fixture
`runs` starts them, computes the references while they run, then reads
their results); each rank is this file run as a script with torchrun's
environment.  They run tests/test_multichip.py's narrow configuration
(fpn_base_channel 4, reg_channel 4, group_cor_dim 4) at H = 128, W = 64,
2 views, batch 2 (two textured planes, _torch_parity.plane_batch, where
the depth attention is decisive, as in tests/test_torch_model.py: on noise
images at these widths near-ties flip hypothesis windows in either
package, and the stage comparator's 36-pixel margin around a flip covers
a whole 32x16 stage), from perturbed flax weights through tools/weights.py:
  - data 2 x spatial 2 (4 ranks; a data row holds one sample, bands of 64
    rows), then
  - spatial 2 alone (ranks 0 and 1 in a group of their own; one data row
    of both samples), and there also the sine depth encoding (pos_enc 1),
    against its own single-process forward, and bfloat16 compute, which
    must run to finite band maps: at these widths its rounding alone moves
    stage-1 attention by up to 0.15 on average between two summation
    orders of the same bf16 forward (measured, whole image against bands,
    one test process against another), past tests/test_bf16.py's criteria,
    so it is held to no reference here.
Each rank records its band's outputs, the shapes of the stage volumes that
its cost volume gave and the rows of every conv's input, then gathers its
data row's maps (gather_rows).  The references: the port's single-process
eval forward on the whole batch, itself held against the JAX package's
single-device model.apply (not against JAX's spatial step, which fails on
its own: ROADMAP R1).  Tolerances: every stage's hypotheses at rtol 1e-5
(no window moves), stage 1's attention at atol 1e-4, and the stage
comparator (_torch_parity.assert_stage_close, attention atol 2e-3, as
the port against JAX and the card against the CPU).  A band's convs and
resizes sum and round in another order than the whole image's, and
Reg2d amplifies that: measured, stage 1's attention within 8.2e-6 and
stage 4's within 1.25e-3.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

CFG = dict(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
           fpn_base_channel=4, reg_channel=4, attn_temp=2.0)
H, W, VIEWS, BATCH = 128, 64, 2, 2
STAGE_KEYS = ("attn_weight", "hypo_depth", "depth", "photometric_confidence")
# further row-local settings, spatial 2 alone
EXTRA = {"pos_enc_sine": dict(pos_enc=1), "bf16": dict(compute_dtype="bfloat16")}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sample():
    from _torch_parity import plane_batch

    batch = plane_batch(BATCH, h=H, w=W)  # the reference and its first source
    return {"imgs": batch["imgs"][:, :VIEWS], "depth_values": batch["depth_values"],
            "proj_matrices": {k: v[:, :VIEWS] for k, v in batch["proj_matrices"].items()}}


def _inputs(sample, rows=slice(None)):
    from _torch_parity import t

    return (t(sample["imgs"][rows]),
            {k: t(v[rows]) for k, v in sample["proj_matrices"].items()},
            t(sample["depth_values"][rows]))


def _model(sd, **overrides):
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

    model = MVS4Net(MVS4NetConfig(**dict(CFG, **overrides)))
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model.eval()


# ---------------------------------------------------------------- the ranks

def _run_case(sd, sample, data, spatial, groups=None, **overrides):
    """One rank's spatial forward under a (data x spatial) split: its band's
    outputs and shapes, and its data row's gathered maps."""
    from mvster_tpu_torch.dist import spatial as sp
    from mvster_tpu_torch.models import mvs4net

    groups = groups or sp.make_2d_groups(data, spatial)
    rows = slice(groups.data_row * BATCH // data, (groups.data_row + 1) * BATCH // data)
    model = _model(sd, **overrides)
    volumes, conv_rows = [], []
    build = mvs4net.build_cost_volume

    def recording(ref, src, *args, **kwargs):
        out = build(ref, src, *args, **kwargs)
        volumes.append((tuple(out.shape), tuple(src.shape), kwargs["row0"]))
        return out

    def conv_input(mod, args):  # registered before the halo hooks: the band's rows
        conv_rows.append((args[0].shape[-2], args[0].shape[-1]))

    outs = []
    hooks = [m.register_forward_pre_hook(conv_input) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose3d))]
    hooks.append(model.register_forward_hook(lambda mod, args, out: outs.append(out)))
    mvs4net.build_cost_volume = recording
    try:  # one step: its outputs and the stage outputs of its forward
        depth, conf = sp.make_spatial_infer_step(model, groups)(*_inputs(sample, rows))
    finally:
        mvs4net.build_cost_volume = build
        for h in hooks:
            h.remove()
    (out,) = outs
    result = {"groups": groups, "volumes": volumes,
              "conv_rows": conv_rows, "depth": depth.numpy(), "conf": conf.numpy(),
              "band": {f"stage{s}": {k: out[f"stage{s}"][k].numpy() for k in STAGE_KEYS}
                       for s in range(1, 5)}}
    result["gathered"] = {
        key: {k: sp.gather_rows(torch.from_numpy(v), groups).numpy() for k, v in st.items()}
        for key, st in result["band"].items()}
    result["gathered_depth"] = sp.gather_rows(depth, groups).numpy()
    return result


def _worker(tmp):
    import torch.distributed as dist

    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank, world = maybe_initialize_distributed("cpu")
    out = {"2x2": _run_case(inputs["sd"], inputs["sample"], 2, 2)}
    dist.destroy_process_group()
    if rank < 2:  # spatial 2 alone, ranks 0 and 1 in a world of their own
        os.environ.update(WORLD_SIZE="2", MASTER_PORT=str(inputs["port"]))
        maybe_initialize_distributed("cpu")
        out["1x2"] = _run_case(inputs["sd"], inputs["sample"], 1, 2)
        groups = out["1x2"]["groups"]
        for name, overrides in EXTRA.items():
            out[name] = _run_case(inputs["sd"], inputs["sample"], 1, 2, groups, **overrides)
        dist.destroy_process_group()
    for res in out.values():
        res["groups"] = (res["groups"].data_row, res["groups"].band)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------- the references

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _torch_parity import jax_variables, run_jax_model, to_numpy_tree
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    tmp = str(tmp_path_factory.mktemp("spatial"))
    sample = _sample()
    variables = jax_variables(JaxConfig(**CFG), sample, seed=0)
    sd = state_dict_from_jax(variables)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"sd": sd, "sample": sample, "port": _free_port()}, f)
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(__file__)),
                                           os.path.dirname(__file__)]))
    procs = [subprocess.Popen([sys.executable, __file__, tmp], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        with torch.no_grad():
            single = to_numpy_tree(_model(sd)(*_inputs(sample)))
            extra = {name: to_numpy_tree(_model(sd, **overrides)(*_inputs(sample)))
                     for name, overrides in EXTRA.items()}
        jax_out = run_jax_model(JaxConfig(**CFG), variables, sample)
    finally:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"single": single, "jax": jax_out, "ranks": ranks, "extra": extra}


def _cases(runs):
    """(case, rank, its result, the batch rows of its data row)."""
    for r, out in enumerate(runs["ranks"]):
        for case, res in out.items():
            if case in EXTRA:
                continue
            data = 2 if case == "2x2" else 1
            row = res["groups"][0]
            yield case, r, res, slice(row * BATCH // data, (row + 1) * BATCH // data)


# ------------------------------------------------------------------- tests

def test_single_process_forward_matches_jax(runs):
    from _torch_parity import assert_stage_close

    assert_stage_close(runs["jax"], runs["single"])


def test_spatial_step_matches_the_single_process_forward(runs):
    from _torch_parity import assert_stage_close

    seen = set()
    for case, r, res, rows in _cases(runs):
        seen.add((case, r))
        want = {key: {k: runs["single"][key][k][rows] for k in STAGE_KEYS}
                for key in runs["single"] if key.startswith("stage")}
        got = dict(res["gathered"], depth=res["gathered"]["stage4"]["depth"])
        want["depth"] = want["stage4"]["depth"]
        assert_stage_close(want, got)
        for key in ("stage2", "stage3", "stage4"):  # no window moved
            np.testing.assert_allclose(got[key]["hypo_depth"], want[key]["hypo_depth"],
                                       rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["stage1"]["attn_weight"],
                                   want["stage1"]["attn_weight"], atol=1e-4)
        # the step's outputs are its forward's final stage
        np.testing.assert_array_equal(res["depth"], res["band"]["stage4"]["depth"])
        np.testing.assert_array_equal(res["conf"],
                                      res["band"]["stage4"]["photometric_confidence"])
        np.testing.assert_array_equal(res["gathered_depth"], got["depth"])
    assert seen == {("2x2", 0), ("2x2", 1), ("2x2", 2), ("2x2", 3), ("1x2", 0), ("1x2", 1)}


def test_row_local_variants_match_their_single_process_forward(runs):
    from _torch_parity import assert_stage_close

    for r in (0, 1):
        for name in EXTRA:
            res, want = runs["ranks"][r][name], runs["extra"][name]
            got = dict(res["gathered"], depth=res["gathered"]["stage4"]["depth"])
            assert res["depth"].shape == (BATCH, H // 2, W)
            assert np.isfinite(res["depth"]).all() and np.isfinite(res["conf"]).all()
            if name != "bf16":
                assert_stage_close(want, got)


def test_each_rank_holds_only_its_band(runs):
    for case, r, res, rows in _cases(runs):
        b = rows.stop - rows.start
        assert res["groups"] == ((r // 2, r % 2) if case == "2x2" else (0, r))
        assert res["depth"].shape == res["conf"].shape == (b, H // 2, W)
        for s, (volume, src, row0) in enumerate(res["volumes"]):
            h, w, d = H // 2 ** (3 - s), W // 2 ** (3 - s), (8, 8, 4, 4)[s]
            # the stage volume is the band's, the sources whole, the offset global
            assert volume == (b, d, h // 2, w, 4), (case, r, s, volume)
            assert src == (VIEWS - 1, b, h, w, CFG["fpn_base_channel"] * 2 ** (3 - s))
            assert row0 == (r % 2) * h // 2
        # every conv of the FPN and Reg2d sees a band: half the rows at its width
        assert res["conv_rows"] and all(rows_ * W == w * H // 2 for rows_, w in res["conv_rows"])


def test_bad_height_raises():
    from mvster_tpu_torch.dist.spatial import SpatialGroups, make_spatial_infer_step

    step = make_spatial_infer_step(_model(None), SpatialGroups(1, 2, 0, 0, None, None))
    sample = _sample()
    sample["imgs"] = sample["imgs"][:, :, :64]
    with pytest.raises(ValueError, match="multiple of 64 x spatial 2"):
        step(*_inputs(sample))


@pytest.mark.parametrize("row0", [0, 16, 40])
def test_cost_volume_on_a_band_is_the_whole_volume_cropped(row0):
    """K1's plain version with a band offset and whole sources against the
    whole image's volume cut to the band's rows, and the band's plane-sweep
    coordinates against the whole grid's (bitwise: one pixel's arithmetic)."""
    from _torch_parity import stage_inputs, t
    from mvster_tpu_torch.core.geometry import plane_sweep_coords
    from mvster_tpu_torch.kernels.warp_correlate import fused_cost_volume

    inp = stage_inputs(3, 64, 48, 8, 4, nsrc=2)
    ref, src, ref_proj, src_projs, hypo = (t(inp[k]) for k in
                                           ("ref", "src", "ref_proj", "src_projs", "hypo"))
    band = slice(row0, row0 + 16)
    for v in range(2):
        xb, yb = plane_sweep_coords(src_projs[v], ref_proj, hypo[:, :, band], row0)
        x, y = plane_sweep_coords(src_projs[v], ref_proj, hypo)
        assert torch.equal(xb, x[:, :, band]) and torch.equal(yb, y[:, :, band])
    for fuse in (True, False):
        whole = fused_cost_volume(ref, src, ref_proj, src_projs, hypo, 4, 2.0, fuse)
        got = fused_cost_volume(ref[:, band].contiguous(), src, ref_proj, src_projs,
                                hypo[:, :, band].contiguous(), 4, 2.0, fuse, row0)
        torch.testing.assert_close(got, whole[:, :, band], atol=1e-6, rtol=1e-6)


if __name__ == "__main__":
    _worker(sys.argv[1])
