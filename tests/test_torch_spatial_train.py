"""The image-row sharded train step (dist/spatial.make_spatial_train_step) against one process's.

Four gloo ranks on the CPU, spawned once for the file (the module fixture
`runs` starts them, computes the references while they run, then reads
their results); each rank is this file run as a script with torchrun's
environment.  They run tests/test_torch_spatial.py's narrow configuration
(fpn_base_channel 4, reg_channel 4, group_cor_dim 4) with the mono branch
on, at H = 128, W = 64, 2 views, batch 2 (two textured planes,
_torch_parity.plane_batch), 3 Sinkhorn iterations and the mono L1 weighed
in (l1ot_lw (1, 1), so the mono decoder's halos carry gradients), one SGD
step (lr 1e-3: Adam's first step turns float noise into +-lr), from
perturbed flax weights through tools/weights.py.  Sample 1's masks lose
their top quarter of rows at every stage, so its two bands hold different
counts of valid pixels:
  - data 2 x spatial 2 (4 ranks; a data row holds one sample, bands of 64
    rows), then
  - spatial 2 alone (ranks 0 and 1 in a group of their own; one data row
    of both samples),
each in float64 with the `xla` loss, in float32 with the `xla` and
the `pallas` loss (its plain version on the CPU), and in bfloat16 compute
(`xla`).  The references, on the whole batch: the port's single-process step
(make_train_step) in float64, float32 and bf16, and the JAX package's
single-device make_train_step (float32, xla; not JAX's spatial step,
which fails on its own: ROADMAP R1).  Tolerances:
  - float64: every gradient and every parameter and running statistic
    after the step within relative L2 F64_RTOL of the single process's,
    and the scalars at rtol 1e-6.  The Sinkhorn runs in float32 in both
    steps, as in both packages, so a band's attention, rounded to float32,
    can differ by an ulp from the whole image's, and the loss's float32
    sums round in another order.  Measured: gradients within 7.3e-9 (with
    the Sinkhorn computed in float64 instead, 4.6e-12), parameters within
    3.8e-12, running statistics within 1.2e-13, scalars within 1.7e-7;
  - float32: the scalars against JAX's by _torch_parity.check_scalars'
    rtol 1e-5 (the pixel fractions within one pixel: a depth within
    float32 rounding of a threshold lands on either side), and each
    gradient with the float64 step as arbiter (_check_grads);
  - bf16: against one process's bf16 step by tests/test_torch_bf16.py's
    train step criteria, with one process's float32 step as the
    gradients' arbiter;
  - the ranks' parameters and running statistics bitwise equal, and their
    scalars equal;
  - the depth metrics those of whole images: the band formula of the
    data-parallel step (a mean over each band's pixels) misses them on
    sample 1.
The exchanges alone, in float64 on the 2 x 2 ranks: a conv stack through
RowBand.halo_convs (a 3x3 conv, a stride-2 conv and Reg2d's transposed
conv), RowBand.resize, RowBand.gather, the group's mean and max over a
data row's own images (the channel-attention pools), DCN on a band and
halos taller than a band (also with the four ranks as one spatial group),
each band's gradient against the slice of the whole map's; and, for the
base model and every variant, the hooks, paddings and band layers after a
step whose loss raised.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from _torch_parity import free_port, spawn_ranks, wait_ranks
CFG = dict(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
           fpn_base_channel=4, reg_channel=4, attn_temp=2.0, mono=True)
H, W, VIEWS, BATCH = 128, 64, 2, 2
LOSS_KW = dict(inverse_depth=True, ot_iter=3, mono=True, l1ot_lw=(1.0, 1.0))
LR = 1e-3
F64_RTOL = 1e-7
# (name, dtype, ot_backend, config overrides) of each step a rank runs
# under each split; "bf16" is bfloat16 compute with float32 parameters
CASES = (("f64", torch.float64, "xla", {}), ("f32", torch.float32, "xla", {}),
         ("f32_pallas", torch.float32, "pallas", {}),
         ("bf16", torch.float32, "xla", dict(compute_dtype="bfloat16")))
SPLITS = {"2x2": (2, 2), "1x2": (1, 2)}
PIXEL_FRACTIONS = ("thres", "s0_range", "s1_range", "s2_range", "s3_range")


def _batch():
    """The numpy batch: two planes, sample 1's masks without their top
    quarter of rows."""
    from _torch_parity import plane_batch

    b = plane_batch(BATCH, h=H, w=W)
    b["imgs"] = b["imgs"][:, :VIEWS]
    b["proj_matrices"] = {k: v[:, :VIEWS] for k, v in b["proj_matrices"].items()}
    for m in b["mask"].values():
        m[1, : m.shape[1] // 4] = 0.0
    return b


def _rows(batch, rows):
    if isinstance(batch, dict):
        return {k: _rows(v, rows) for k, v in batch.items()}
    return batch[rows]


def _torch(batch, dtype):
    if isinstance(batch, dict):
        return {k: _torch(v, dtype) for k, v in batch.items()}
    return torch.from_numpy(np.asarray(batch, np.float64)).to(dtype)


def _model(sd, dtype=torch.float32, **overrides):
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

    model = MVS4Net(MVS4NetConfig(**CFG, **overrides))
    model.load_state_dict(sd, strict=True)
    return model.to(dtype)


def _grads(model):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
            for k, p in model.named_parameters()}


def _state(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _floats(scalars):
    return {k: float(v) for k, v in scalars.items()}


def _loss_kw(backend):
    return dict(LOSS_KW, ot_backend=backend)


# ---------------------------------------------------------------- the ranks

def _spatial_step(sd, batch, groups, dtype, backend, overrides):
    """One rank's spatial step on its data row's batch: scalars, gradients
    (already averaged over the world), state after, its band's images, and
    its band's depth metrics by the band formula (no group)."""
    from mvster_tpu_torch.dist.spatial import RowBand, make_spatial_train_step
    from mvster_tpu_torch.train.metrics import depth_metrics

    model = _model(sd, dtype, **overrides)
    step = make_spatial_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), groups,
                                   loss_kwargs=_loss_kw(backend))
    scalars, images = step(_torch(batch, dtype))
    band = RowBand(groups)
    mask = band.cut(_torch(batch["mask"]["stage4"], dtype)) > 0.5
    gt = band.cut(_torch(batch["depth"]["stage4"], dtype))
    return {"scalars": _floats(scalars), "grads": _grads(model), "after": _state(model),
            "images": {k: v.numpy() for k, v in images.items()},
            "band_metrics": _floats(depth_metrics(images["depth_est_nomask"], gt, mask))}


def _exchanges(groups):
    """Each band's float64 gradients through the exchanges, with the whole
    map's computed here as the reference (the rank holds the whole input)."""
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch import nn

    from mvster_tpu_torch.dist.spatial import RowBand

    band = RowBand(groups)
    g = torch.Generator().manual_seed(7)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)  # noqa: E731
    out = {}

    def grads(fn, x_whole, cot_whole):
        """(band output, band input gradient, whole output, whole input
        gradient) of sum(fn(x) * cot)."""
        xb = band.cut(x_whole).clone().requires_grad_()
        yb = fn(xb, True)
        (yb * band.cut(cot_whole)).sum().backward()
        xw = x_whole.clone().requires_grad_()
        yw = fn(xw, False)
        (yw * cot_whole).sum().backward()
        return yb.detach(), xb.grad, yw.detach(), xw.grad

    # a conv stack through the halo hooks: Reg2d's 3x3, stride-2 and
    # transposed convs, on (B, C, D, H, W)
    convs = nn.Sequential(
        nn.Conv3d(2, 3, (1, 3, 3), padding=(0, 1, 1)),
        nn.Conv3d(3, 3, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1)),
        nn.ConvTranspose3d(3, 2, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1),
                           output_padding=(0, 1, 1))).double()
    for p in convs.parameters():
        p.data = rnd(*p.shape)

    def run_convs(x, banded):
        if not banded:
            return convs(x)
        with band.halo_convs(convs):
            return convs(x)

    x, cot = rnd(1, 2, 2, 16, 6), rnd(1, 2, 2, 16, 6)
    yb, gb, yw, gw = grads(run_convs, x, cot)
    # the weights' gradients: the bands' summed, against the whole map's
    convs.zero_grad()
    run_convs(band.cut(x), True).mul(band.cut(cot)).sum().backward()
    band_w = torch.cat([p.grad.reshape(-1) for p in convs.parameters()])
    dist.all_reduce(band_w, group=band.group)
    convs.zero_grad()
    convs(x).mul(cot).sum().backward()
    whole_w = torch.cat([p.grad.reshape(-1) for p in convs.parameters()])
    out["convs"] = (yb, band.cut(yw), gb, band.cut(gw), band_w, whole_w)

    # the align-corners resize, 8 band rows to 16 (the whole 16 to 32)
    x, cot = rnd(1, 2, 16, 5), rnd(1, 2, 32, 9)
    yb, gb, yw, gw = grads(
        lambda t, banded: band.resize(t, 2 * t.shape[-2], 9) if banded else F.interpolate(
            t, size=(32, 9), mode="bilinear", align_corners=True), x, cot)
    out["resize"] = (yb, band.cut(yw), gb, band.cut(gw))

    # the gather: each band's whole map takes a cotangent of its own, so a
    # band's gradient is its rows of the bands' cotangents summed
    x = rnd(2, 1, 16, 5, 3)
    cots = [rnd(2, 1, 16, 5, 3) for _ in range(band.n)]
    xb = band.cut(x, 2).clone().requires_grad_()
    full = band.gather(xb, dim=2)
    (full * cots[band.index]).sum().backward()
    out["gather"] = (full.detach(), x, xb.grad, band.cut(sum(cots), 2))

    # the group's pools over a data row's own images: each data row draws
    # its own map, so a pool over every rank would mix them; each band's
    # copy of the pooled value takes a cotangent of its own
    gd = torch.Generator().manual_seed(11 + groups.data_row)
    x = torch.randn(2, 3, 2, 8, 5, generator=gd, dtype=torch.float64)
    for name, dims in (("mean", (2, 3, 4)), ("amax", (3, 4))):
        whole_fn = getattr(torch.Tensor, name)
        pooled = whole_fn(x, dims)
        cots = [torch.randn(pooled.shape, generator=gd, dtype=torch.float64)
                for _ in range(band.n)]
        xb = band.cut(x).clone().requires_grad_()
        yb = getattr(band, name)(xb, dims)
        (yb * cots[band.index]).sum().backward()
        xw = x.clone().requires_grad_()
        (whole_fn(xw, dims) * sum(cots)).sum().backward()
        out[name] = (yb.detach(), pooled, xb.grad, band.cut(xw.grad))

    # DCN on a band (its offset and modulation convs through the halo hooks,
    # the taps from the gathered map) against the whole image's DCN cut to
    # the band, with offsets large enough to reach other bands' rows
    from mvster_tpu_torch.nn.dcn import DeformConv2d

    dcn = DeformConv2d(3, 2).double()
    for p in dcn.parameters():
        p.data = rnd(*p.shape)
    dcn.p_conv.weight.data *= 4.0

    def run_dcn(x, banded):
        if not banded:
            return dcn(x)
        with band.halo_convs(dcn):
            return dcn(x)

    x, cot = rnd(1, 3, 16, 6), rnd(1, 2, 16, 6)
    yb, gb, yw, gw = grads(run_dcn, x, cot)
    dcn.zero_grad()
    run_dcn(band.cut(x), True).mul(band.cut(cot)).sum().backward()
    band_w = torch.cat([p.grad.reshape(-1) for p in dcn.parameters()])
    dist.all_reduce(band_w, group=band.group)
    dcn.zero_grad()
    dcn(x).mul(cot).sum().backward()
    whole_w = torch.cat([p.grad.reshape(-1) for p in dcn.parameters()])
    reach = float(dcn.p_conv(x).detach().abs().max())  # the largest offset, in rows or columns
    out["dcn"] = (yb, band.cut(yw), gb, band.cut(gw), band_w, whole_w, reach)
    return out


def _tall_halos(groups):
    """Halos taller than the band (top 3, bottom 2 from bands of one row),
    forward and float64 gradient, against the zero-padded whole map's rows:
    under spatial 4 the halo above the last band reaches three bands."""
    from mvster_tpu_torch.dist.spatial import RowBand

    band = RowBand(groups)
    g = torch.Generator().manual_seed(13)
    top, bottom, rows = 3, 2, 1
    x = torch.randn(2, 3, band.n * rows, 4, generator=g, dtype=torch.float64)
    span = top + rows + bottom
    cots = [torch.randn(2, 3, span, 4, generator=g, dtype=torch.float64)
            for _ in range(band.n)]
    xb = band.cut(x).clone().requires_grad_()
    yb = band.halo(xb, top, bottom)
    (yb * cots[band.index]).sum().backward()
    xw = x.clone().requires_grad_()
    padded = torch.nn.functional.pad(xw, (0, 0, top, bottom))
    windows = [padded[..., r * rows:r * rows + span, :] for r in range(band.n)]
    sum((w * c).sum() for w, c in zip(windows, cots)).backward()
    return yb.detach(), windows[band.index].detach(), xb.grad, band.cut(xw.grad)


def _raise_halfway(groups):
    """A step whose loss raises after the forward, for the base model and
    every variant: the convs' hooks and paddings and the band layers'
    `row_band` after it, against before."""
    from _torch_parity import BAND_VARIANTS, VARIANTS
    from mvster_tpu_torch.dist import spatial
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

    def state(model):
        return [(name, getattr(m, "padding", None), getattr(m, "output_padding", None),
                 len(m._forward_pre_hooks), len(m._forward_hooks), "row_band" in vars(m))
                for name, m in model.named_modules()
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose3d))
                or hasattr(m, "row_band")]

    def loss_fn(*args, **kwargs):
        raise RuntimeError("the loss raised")

    with torch.no_grad():
        batch = _torch(_rows(_batch(), slice(groups.data_row, groups.data_row + 1)),
                       torch.float32)
    out = {}
    for name, overrides in {"base": {}, **VARIANTS, **BAND_VARIANTS}.items():
        torch.manual_seed(0)
        model = MVS4Net(MVS4NetConfig(**dict(CFG, **overrides)))
        before = state(model)
        step = spatial.make_spatial_train_step(
            model, torch.optim.SGD(model.parameters(), lr=LR), groups)
        loss, spatial.mvs4net_loss = spatial.mvs4net_loss, loss_fn
        try:
            step(batch)
            raised = None
        except RuntimeError as exc:
            raised = str(exc)
        finally:
            spatial.mvs4net_loss = loss
        out[name] = {"raised": raised, "before": before, "after": state(model),
                     "band_layers": sum(hasattr(m, "row_band") for m in model.modules())}
    return out


def _worker(tmp):
    import torch.distributed as dist

    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed
    from mvster_tpu_torch.dist.spatial import make_2d_groups

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank, _ = maybe_initialize_distributed("cpu")
    out = {}
    for split, (data, spatial) in SPLITS.items():
        if rank >= data * spatial:
            break
        if split == "1x2":  # ranks 0 and 1 in a world of their own
            dist.destroy_process_group()
            os.environ.update(WORLD_SIZE="2", MASTER_PORT=str(inputs["port"]))
            maybe_initialize_distributed("cpu")
        groups = make_2d_groups(data, spatial)
        rows = slice(groups.data_row * BATCH // data, (groups.data_row + 1) * BATCH // data)
        batch = _rows(inputs["batch"], rows)
        res = {"groups": (groups.data_row, groups.band)}
        for name, dtype, backend, overrides in CASES:
            res[name] = _spatial_step(inputs["sd"], batch, groups, dtype, backend, overrides)
        if split == "2x2":
            res["exchanges"] = _exchanges(groups)
            res["tall_halos"] = _tall_halos(groups)
            res["raise"] = _raise_halfway(groups)
            # the four ranks as one spatial group
            res["tall_halos_1x4"] = _tall_halos(make_2d_groups(1, 4))
        out[split] = res
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------- the references

def _port_single(sd, batch):
    """The port's one-process SGD steps on the whole batch."""
    from mvster_tpu_torch.dist.train_step import make_train_step

    refs = {}
    for name, dtype, backend, overrides in CASES:
        model = _model(sd, dtype, **overrides)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR),
                               loss_kwargs=_loss_kw(backend))
        scalars, images = step(_torch(batch, dtype))
        refs[name] = {"scalars": _floats(scalars), "grads": _grads(model),
                      "after": _state(model),
                      "images": {k: v.numpy() for k, v in images.items()}}
    return refs


def _jax_step(variables, batch):
    """The JAX package's single-device train step (float32, xla) on the
    whole batch: its scalars and gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    from mvster_tpu.dist.train_step import create_train_state, make_train_step
    from mvster_tpu.models import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.convert import export_state_dict

    # optax.sgd(LR) behind a transform that keeps the step's gradients in its state
    record = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(record, optax.sgd(LR))
    step = make_train_step(MVS4Net(MVS4NetConfig(**CFG)), tx, loss_kwargs=LOSS_KW,
                           donate=False)
    state, scalars, _ = step(create_train_state(variables, tx),
                             jax.tree_util.tree_map(jnp.asarray, batch))
    grads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    return {"scalars": _floats(scalars), "grads": export_state_dict({"params": grads})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _torch_parity import jax_train_variables
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    tmp = str(tmp_path_factory.mktemp("spatial_train"))
    batch = _batch()
    variables = jax_train_variables(JaxConfig(**CFG), batch, seed=0)
    sd = state_dict_from_jax(variables)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"sd": sd, "batch": batch, "port": free_port()}, f)
    procs = spawn_ranks(__file__, [tmp], 4)
    try:
        single = _port_single(sd, batch)
        jax_ref = _jax_step(variables, batch)
    finally:
        wait_ranks(procs)
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"single": single, "jax": jax_ref, "ranks": ranks}


def _split_ranks(runs, split):
    data, spatial = SPLITS[split]
    return [runs["ranks"][r][split] for r in range(data * spatial)]


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("split", list(SPLITS))
def test_float64_step_equals_the_single_process_step(runs, split):
    """The proof of the gradient scaling: the halos' and gathers' backward
    sums over the spatial group, the world's average of the rest."""
    from _torch_parity import GRAD_NOISE, relative_l2

    want = runs["single"]["f64"]
    for res in _split_ranks(runs, split):
        got = res["f64"]
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


def _check_grads(got, want, exact, single):
    """Each float32 gradient tensor of the spatial step (`got`) against the
    float64 step's (`exact`): e_port, its relative L2 distance, at most
    twice that of the port's one-process float32 step (`single`), or 1e-4
    (measured: at most 1.08 times); and against JAX's (`want`) within the
    two steps' summed float32 noise, max(1e-4, 1.5 (e_port + e_jax)), with
    e_jax <= 5e-2 (_torch_parity.check_grads' rule).  check_grads' further
    e_jax <= 30 e_port does not hold here for JAX's own reasons: at these
    widths its float32 step lies up to ~1e-3 from the float64 one where the
    port's lies ~1e-5 (feature.conv0.0.bn.bias: 1.1e-3 against 9.1e-6)."""
    from _torch_parity import GRAD_NOISE, relative_l2

    assert got.keys() == want.keys() == exact.keys()
    for key, e in exact.items():
        g, w = got[key], want[key]
        if np.linalg.norm(e) < GRAD_NOISE:  # zero in exact arithmetic
            np.testing.assert_allclose(g, w, atol=GRAD_NOISE, err_msg=key)
            continue
        e_port, e_jax = relative_l2(g, e), relative_l2(w, e)
        assert e_jax <= 5e-2, (key, e_jax)
        assert e_port <= max(1e-4, 2 * relative_l2(single[key], e)), (key, e_port)
        assert relative_l2(g, w) <= max(1e-4, 1.5 * (e_port + e_jax)), (
            key, relative_l2(g, w), e_port, e_jax)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("case", ["f32", "f32_pallas"])
def test_float32_step_matches_jax(runs, split, case):
    """Scalars against the JAX package's single-device step; gradients
    against it with the port's single-process float64 step as the arbiter."""
    jax_s = runs["jax"]["scalars"]
    for res in _split_ranks(runs, split):
        got = res[case]["scalars"]
        assert got.keys() == jax_s.keys()
        for key, want in jax_s.items():
            # a pixel fraction may move by one of its pixels (4096 at stage 4)
            atol = 1.0 / (BATCH * H * W) if key.startswith(PIXEL_FRACTIONS) else 1e-7
            np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=atol, err_msg=key)
        _check_grads(res[case]["grads"], runs["jax"]["grads"], runs["single"]["f64"]["grads"],
                     runs["single"][case]["grads"])


@pytest.mark.parametrize("split", list(SPLITS))
def test_bf16_step_matches_the_single_process_bf16_step(runs, split):
    """bfloat16 compute through the exchanges (halos in float32 both ways)
    against one process's bf16 step, by tests/test_torch_bf16.py's train
    step criteria: the loss within rtol 1e-3 and each stage's losses within
    5e-2 (measured 2.6e-4 and 7.1e-3).  Each bf16 step's gradients lie far
    from the float32 step at these widths (relative L2, median over the
    tensors 0.81 for one process), so the spatial step's median distance
    is held within 1.5x one process's (measured 1.00x and 0.98x), and
    every gradient and image is finite."""
    from _torch_parity import GRAD_NOISE, relative_l2

    one, arbiter = runs["single"]["bf16"], runs["single"]["f32"]["grads"]
    for res in _split_ranks(runs, split):
        got = res["bf16"]
        assert all(np.isfinite(v).all() for v in got["grads"].values())
        assert all(np.isfinite(v).all() for v in got["images"].values())
        np.testing.assert_allclose(got["scalars"]["loss"], one["scalars"]["loss"], rtol=1e-3)
        for key in one["scalars"]:
            if key.endswith(("_d_loss", "_c_loss")):
                np.testing.assert_allclose(got["scalars"][key], one["scalars"][key], rtol=5e-2,
                                           atol=1e-6, err_msg=key)
        e_sp, e_one = zip(*[(relative_l2(got["grads"][k], e), relative_l2(one["grads"][k], e))
                            for k, e in arbiter.items() if np.linalg.norm(e) >= GRAD_NOISE])
        assert np.median(e_sp) <= 1.5 * np.median(e_one), (np.median(e_sp), np.median(e_one))


@pytest.mark.parametrize("split", list(SPLITS))
def test_ranks_agree_bitwise(runs, split):
    parts = _split_ranks(runs, split)
    for name, *_ in CASES:
        first = parts[0][name]
        for res in parts[1:]:
            assert res[name]["scalars"] == first["scalars"], name
            for key, v in first["after"].items():
                np.testing.assert_array_equal(res[name]["after"][key], v, err_msg=key)


@pytest.mark.parametrize("split", list(SPLITS))
def test_images_are_the_bands_of_the_single_process_images(runs, split):
    """Each rank's images are its band of its data row's, by the float64
    step (where no float32 near-tie moves a depth)."""
    data, spatial = SPLITS[split]
    want = runs["single"]["f64"]["images"]
    for r, res in enumerate(_split_ranks(runs, split)):
        row, b = res["groups"]
        assert (row, b) == (r // spatial, r % spatial)
        rows = slice(row * BATCH // data, (row + 1) * BATCH // data)
        for key, img in res["f64"]["images"].items():  # rows on axis 1
            whole = want[key][rows]
            h = whole.shape[1]
            band = whole[:, b * h // spatial:(b + 1) * h // spatial]
            np.testing.assert_allclose(img, band, rtol=1e-9, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("split", list(SPLITS))
def test_depth_metrics_are_those_of_whole_images(runs, split):
    """The step's metrics equal the single process's (whole images), where
    the band formula, each band's own masked mean as the data-parallel
    step takes it, misses them: sample 1's bands hold 32 and 64 valid rows
    of 64."""
    keys = ("abs_depth_error", "thres2mm_error", "thres4mm_error", "thres8mm_error")
    want = runs["single"]["f64"]["scalars"]
    for res in _split_ranks(runs, split):
        for key in keys:
            np.testing.assert_allclose(res["f64"]["scalars"][key], want[key], rtol=1e-9,
                                       err_msg=key)
    # the band formula's metric over the world, what the step returned
    # before its repair, misses by ~2e-4 of the value: 1e5 times the
    # tolerance above
    band_err = _split_ranks(runs, split)[-1]["f64"]["band_metrics"]["abs_depth_error"]
    assert abs(band_err - want["abs_depth_error"]) > 1e-5 * abs(want["abs_depth_error"])


def test_exchanges_carry_the_whole_maps_gradients(runs):
    for res in _split_ranks(runs, "2x2"):
        ex = res["exchanges"]
        yb, yw, gb, gw, band_w, whole_w = ex["convs"]
        torch.testing.assert_close(yb, yw, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(gb, gw, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(band_w, whole_w, rtol=1e-12, atol=1e-12)
        yb, yw, gb, gw = ex["resize"]
        torch.testing.assert_close(yb, yw, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(gb, gw, rtol=1e-12, atol=1e-12)
        full, x, gb, gw = ex["gather"]
        assert torch.equal(full, x)
        torch.testing.assert_close(gb, gw, rtol=1e-12, atol=1e-12)


def test_exchanges_pool_and_sample_over_the_whole_map(runs):
    """The group's mean and max of a data row's own images and DCN on a
    band, forward and float64 gradients, against the whole map's."""
    for res in _split_ranks(runs, "2x2"):
        ex = res["exchanges"]
        for name in ("mean", "amax"):
            yb, yw, gb, gw = ex[name]
            torch.testing.assert_close(yb, yw, rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(gb, gw, rtol=1e-12, atol=1e-12)
        yb, yw, gb, gw, band_w, whole_w, reach = ex["dcn"]
        assert reach > 8  # some tap reaches past a whole band of 8 rows
        torch.testing.assert_close(yb, yw, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(gb, gw, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(band_w, whole_w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("split", ["tall_halos", "tall_halos_1x4"])
def test_tall_halos_read_every_band_they_reach(runs, split):
    for res in _split_ranks(runs, "2x2"):
        yb, yw, gb, gw = res[split]
        assert torch.equal(yb, yw)
        torch.testing.assert_close(gb, gw, rtol=1e-12, atol=1e-12)


def test_hooks_and_paddings_are_restored_after_a_step_that_raised(runs):
    from _torch_parity import BAND_VARIANTS, VARIANTS

    for res in _split_ranks(runs, "2x2"):
        assert res["raise"].keys() == {"base", *VARIANTS, *BAND_VARIANTS}
        for name, out in res["raise"].items():
            assert out["raised"] == "the loss raised", name
            assert out["after"] == out["before"], name
            assert all(pre == post == 0 and not own for *_, pre, post, own in out["after"])
        # the layers that take a band: CAM's and DCAM's conv2, conv4 and
        # conv6 at each of 4 stages, and DCN's four heads
        layers = {name: out["band_layers"] for name, out in res["raise"].items()}
        assert layers["cam"] == layers["dcam"] == 12 and layers["dcn"] == 4
        assert sum(layers.values()) == 28, layers


def test_bad_height_raises():
    from mvster_tpu_torch.dist.spatial import SpatialGroups, make_spatial_train_step
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

    model = MVS4Net(MVS4NetConfig(**CFG))
    step = make_spatial_train_step(model, torch.optim.SGD(model.parameters(), lr=LR),
                                   SpatialGroups(1, 2, 0, 0, None, None))
    batch = _torch(_rows(_batch(), slice(0, 1)), torch.float32)
    batch["imgs"] = batch["imgs"][:, :, :64]
    with pytest.raises(ValueError, match="multiple of 64 x spatial 2"):
        step(batch)


if __name__ == "__main__":
    _worker(sys.argv[1])
