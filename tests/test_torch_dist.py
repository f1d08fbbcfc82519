"""Data-parallel training of the port against the JAX package's sharded step.

Two gloo ranks on the CPU, spawned once for the file (the module fixture
`runs` starts them, computes the references while they run, then reads
their results); each rank is this file run as a script with torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), so it joins
through dist.mesh.maybe_initialize_distributed.  The model is
tests/test_multichip.py's narrow config (fpn_base_channel 4, reg_channel
4, group_cor_dim 4) at 64x64, 2 views, global batch 4 (2 a rank), from
the JAX package's perturbed weights through tools/weights.py; 3 Sinkhorn
iterations, SGD at lr 1e-3 (test_multichip.py's reason: Adam's first step
turns float noise into +-lr).  Rank 1's masks lose the left half of every
stage (so the ranks' mask counts differ); in the eval batch they are all
zero (a rank with no valid pixel).  The references: the JAX package's
make_train_step / make_eval_step on a 2-device CPU mesh
(mvster_tpu.dist.mesh.make_data_mesh(2), as test_multichip.py), and the
port's own single-process step on the whole batch, in float32 and in
float64 (the exact value every float32 step approximates).  Tolerances:
  - loss and every scalar at rtol 1e-5 (atol 1e-7) against the port's
    one-process step; against JAX's sharded step at rtol 1e-5 widened by
    JAX's own float32 error (|JAX - float64|), and by one pixel in the
    pixel fractions (range_err_ratio and the thresholds: a value within
    float32 rounding of its threshold lands on either side);
  - parameters after the step at rtol 1e-2, atol 1e-5
    (test_multichip.py's) against the port's one-process step, the
    float64 step and JAX's one-device step; against JAX's 2-device step by
    gradient (_check_grads), since that step's own float32 gradients of
    the narrow FPN lie ~5e-2 from the float64 ones and its parameters miss
    this tolerance against JAX's one-device step at a few elements;
  - BatchNorm running statistics bitwise equal across the ranks, and
    against JAX's and the single process's at rtol 1e-4 (atol 1e-5,
    _torch_parity.check_after's);
  - grad_accum=2 as the step, against the JAX accum step fed the global
    batch microbatch-major (global microbatch i = the i-th sample of each
    rank) and the port's float64 step on that batch;
  - the eval scalars against JAX's sharded eval step at rtol 1e-5;
  - global_mean and the two Sinkhorn losses against their single-process
    values at rtol 1e-6 and gradients (times the world size, which DDP's
    average divides out) at rtol 1e-5.
At world size 1 the step is today's bit for bit.
"""

from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from _torch_parity import free_port, spawn_ranks, wait_ranks
CFG = dict(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
           fpn_base_channel=4, reg_channel=4, attn_temp=2.0)
LOSS_KW = dict(inverse_depth=True, ot_iter=3)
LR = 1e-3
WORLD = 2
GLOBAL_BATCH = 4
TRAIN_FLAGS = ["--nviews", "3", "--batch_size", "4", "--epochs", "1", "--group_cor",
               "--inverse_depth", "--attn_temp", "2", "--fpn_base_channel", "4",
               "--reg_channel", "4", "--group_cor_dim", "4,4,4,4", "--ot_iter", "3",
               "--summary_freq", "1", "--seed", "3", "--device", "cpu"]
OT_SHAPE = (GLOBAL_BATCH, 4, 8, 8)  # Sinkhorn inputs: B, D, H, W


def _batches():
    """The global train batch (rank 1's masks halved) and eval batch (rank
    1's masks zero), numpy."""
    from helpers import synthetic_sample

    s = synthetic_sample(0, batch=GLOBAL_BATCH, nviews=2, h=64, w=64, with_gt=True)
    train = {k: s[k] for k in ("imgs", "proj_matrices", "depth_values", "depth", "mask")}
    half = GLOBAL_BATCH // WORLD
    train["mask"] = {k: v.copy() for k, v in s["mask"].items()}
    for v in train["mask"].values():
        v[half:, :, : v.shape[2] // 2] = 0.0
    evalb = dict(train, mask={k: v.copy() for k, v in s["mask"].items()})
    for v in evalb["mask"].values():
        v[half:] = 0.0
    return train, evalb


def _take(batch, idx):
    if isinstance(batch, dict):
        return {k: _take(v, idx) for k, v in batch.items()}
    return np.ascontiguousarray(batch[idx])


def _shard(batch, rank):
    half = GLOBAL_BATCH // WORLD
    return _take(batch, slice(rank * half, (rank + 1) * half))


def _microbatch_major(batch):
    """The global batch as the port's grad_accum=2 sees it on 2 ranks:
    microbatch i = the i-th sample of each rank's shard."""
    return _take(batch, np.array([0, 2, 1, 3]))


def _ot_inputs():
    rng = np.random.default_rng(5)
    b, d, h, w = OT_SHAPE
    attn = rng.dirichlet(np.ones(d), size=(b, h, w)).transpose(0, 3, 1, 2)
    hypo = np.sort(rng.uniform(450, 900, size=(b, d, h, w)), axis=1)
    gt = rng.uniform(450, 900, size=(b, h, w))
    mask = rng.uniform(size=(b, h, w)) > 0.3
    mask[2:, :, :5] = False  # unequal counts on the ranks
    return [np.asarray(x, np.float32) for x in (gt, hypo, attn)] + [mask]


def _ot_losses(gt, hypo, attn, mask):
    """Both Sinkhorn losses of the port and their gradients by attn."""
    from mvster_tpu_torch.core.sinkhorn import sinkhorn
    from mvster_tpu_torch.kernels.sinkhorn_ot import sinkhorn_loss_fused

    out = {}
    for name, fn in (("xla", lambda *a: sinkhorn(*a, iters=3)[1]),
                     ("pallas", lambda *a: sinkhorn_loss_fused(*a, iters=3))):
        a = torch.from_numpy(attn).requires_grad_()
        loss = fn(torch.from_numpy(gt), torch.from_numpy(hypo), a, torch.from_numpy(mask))
        loss.backward()
        out[name] = (loss.item(), a.grad.numpy().copy())
    return out


def _port_model(sd):
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

    model = MVS4Net(MVS4NetConfig(**CFG))
    model.load_state_dict(sd, strict=True)
    return model


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _grads(model):
    return {k: p.grad.double().numpy().copy() for k, p in model.named_parameters()}


def _floats(scalars):
    return {k: float(v) for k, v in scalars.items()}


# ---------------------------------------------------------------- the ranks

def _worker(tmp):
    """One rank: the step cases under one group, then tools.train.main in
    groups of its own (a port each, from the parent)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from _torch_parity import torch_batch
    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed
    from mvster_tpu_torch.dist.reduce import global_mean
    from mvster_tpu_torch.dist.train_step import make_eval_step, make_train_step
    from mvster_tpu_torch.models.losses import mvs4net_loss

    torch.set_num_threads(int(os.environ["TEST_THREADS"]))
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    rank, world = maybe_initialize_distributed("cpu")
    out = {"rank": rank, "world": world, "backend": dist.get_backend()}

    def wrapped():
        model = _port_model(inputs["sd"])
        before = _state(model)
        ddp = DistributedDataParallel(model, broadcast_buffers=False)
        out["broadcast_changed"] = [k for k, v in _state(model).items()
                                    if not np.array_equal(v, before[k])]
        return model, ddp

    train, evalb = (torch_batch(_shard(b, rank)) for b in (inputs["train"], inputs["eval"]))
    for name, accum in (("step", 1), ("accum", 2)):
        model, ddp = wrapped()
        step = make_train_step(ddp, torch.optim.SGD(ddp.parameters(), lr=LR), mvs4net_loss,
                               LOSS_KW, grad_accum=accum)
        out[name] = {"scalars": _floats(step(train)[0]), "after": _state(model),
                     "grads": _grads(model)}
    model, ddp = wrapped()
    out["eval"] = _floats(make_eval_step(ddp, mvs4net_loss, LOSS_KW)(evalb))

    # global_mean with unequal counts, and with a rank holding none
    for case, nums, counts in (("unequal", (2.0, 5.0), (4.0, 2.0)),
                               ("empty", (2.0, 0.0), (4.0, 0.0))):
        num = torch.tensor(nums[rank], requires_grad=True)
        value = global_mean(num, torch.tensor(counts[rank]))
        value.backward()
        out[case] = (float(value), float(num.grad))
    ot = [_take(x, slice(2 * rank, 2 * rank + 2)) for x in inputs["ot"]]
    out["ot"] = _ot_losses(*ot)
    dist.destroy_process_group()

    out["main"] = _worker_main(tmp, inputs["ports"])
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _worker_main(tmp, ports):
    from mvster_tpu_torch.data.dtu import DTUDataset
    from mvster_tpu_torch.data.common import nearest_resize
    from mvster_tpu_torch.tools import train

    # the synthetic maps are 2x the 64x128 images: no 512x640 crop
    DTUDataset._prepare_map = lambda self, hr: nearest_resize(
        hr, hr.shape[0] // 2, hr.shape[1] // 2)
    saves = []
    save = torch.save
    torch.save = lambda obj, path, *a, **k: (saves.append(str(path)), save(obj, path, *a, **k))
    tree = os.path.join(tmp, "dtu")
    argv = ["--trainpath", tree, "--trainlist", f"{tree}/train.txt", "--testlist",
            f"{tree}/train.txt", "--logdir", os.path.join(tmp, "log"), *TRAIN_FLAGS]
    out = {}
    os.environ["MASTER_PORT"] = str(ports[0])
    out["first"] = train.main(argv)
    out["first_saves"] = list(saves)
    os.environ["MASTER_PORT"] = str(ports[1])
    out["resumed"] = train.main([*argv, "--resume", "--epochs", "2"])
    os.environ["MASTER_PORT"] = str(ports[2])
    try:
        train.main([*argv, "--batch_size", "3"])
    except ValueError as exc:
        out["odd_batch"] = str(exc)
    torch.save = save
    return out


# ----------------------------------------------------------- the references

def _jax_references(variables, train, evalb):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mvster_tpu.dist.mesh import make_data_mesh
    from mvster_tpu.dist.train_step import create_train_state, make_eval_step, make_train_step
    from mvster_tpu.models import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.convert import export_state_dict

    model = MVS4Net(MVS4NetConfig(**CFG))
    mesh = make_data_mesh(WORLD)
    rep, shd = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    # optax.sgd(LR) behind a transform that keeps the step's gradients in its state
    record = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(record, optax.sgd(LR))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    refs = {}
    for name, accum, batch, on_mesh in (("step", 1, train, True),
                                        ("step_one_device", 1, train, False),
                                        ("accum", 2, _microbatch_major(train), True)):
        step = make_train_step(model, tx, loss_kwargs=LOSS_KW, mesh=mesh if on_mesh else None,
                               donate=False, grad_accum=accum)
        put = jax.device_put if on_mesh else (lambda x, _: x)
        state, scalars, _ = step(put(create_train_state(variables, tx), rep), put(batch, shd))
        refs[name] = {"scalars": _floats(scalars),
                      "after": export_state_dict({"params": to_np(state.params),
                                                  "batch_stats": to_np(state.batch_stats)}),
                      "grads": export_state_dict({"params": to_np(state.opt_state[0])})}
    eval_step = make_eval_step(model, loss_kwargs=LOSS_KW, mesh=mesh)
    refs["eval"] = _floats(eval_step(variables["params"], variables["batch_stats"],
                                     jax.device_put(evalb, shd)))
    return refs


def _port_step(sd, batch, grad_accum=1, lr=LR, dtype=torch.float32):
    from _torch_parity import torch_batch
    from mvster_tpu_torch.dist.train_step import make_train_step

    model = _port_model(sd).to(dtype)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=lr),
                           loss_kwargs=LOSS_KW, grad_accum=grad_accum)
    cast = lambda x: ({k: cast(v) for k, v in x.items()} if isinstance(x, dict)  # noqa: E731
                      else x.to(dtype))
    scalars = _floats(step(cast(torch_batch(batch)))[0])
    return {"scalars": scalars, "grads": _grads(model),
            "after": {k: v.astype(np.float32) if v.dtype == np.float64 else v
                      for k, v in _state(model).items()}}


def _port_single(sd, train):
    """The port's one-process steps on the whole batch, in float32 and in
    float64 (the exact value that every float32 step approximates), the
    grad_accum=2 step on the microbatch-major batch in both, and the
    loss of each rank's shard alone (what per-rank BatchNorm and means
    would give)."""
    return {"step": _port_step(sd, train),
            "exact": _port_step(sd, train, dtype=torch.float64),
            "accum": _port_step(sd, _microbatch_major(train), grad_accum=2),
            "exact_accum": _port_step(sd, _microbatch_major(train), grad_accum=2,
                                      dtype=torch.float64),
            "local_losses": [_port_step(sd, _shard(train, r), lr=0.0)["scalars"]["loss"]
                             for r in range(WORLD)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _torch_parity import jax_train_variables, write_dtu_tree
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    tmp = str(tmp_path_factory.mktemp("dist"))
    train, evalb = _batches()
    variables = jax_train_variables(JaxConfig(**CFG), train, seed=0)
    sd = state_dict_from_jax(variables)
    write_dtu_tree(os.path.join(tmp, "dtu"), n_views=3, h=64, w=128, n_refs=1)  # 7 samples
    ot = _ot_inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"sd": sd, "train": train, "eval": evalb, "ot": ot,
                     "ports": [free_port() for _ in range(3)]}, f)

    threads = max(1, torch.get_num_threads() // WORLD)
    procs = spawn_ranks(__file__, [tmp], WORLD, TEST_THREADS=str(threads))
    try:
        refs = {"jax": _jax_references(variables, train, evalb), "single": _port_single(sd, train),
                "ot": _ot_losses(*ot), "sd": sd}
    finally:
        logs = wait_ranks(procs)
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return dict(refs, ranks=ranks, tmp=tmp, logs=logs, train=train)


# ------------------------------------------------------------------- tests

def _one_pixel(batch, key):
    """What one pixel moves the scalar `key` of a train step on `batch`: a
    depth error within float32 rounding of 2, 4 or 8 mm, or a GT depth of
    the hypothesis range's edge, lands on either side of it.  The
    threshold metrics are means over images of the final stage's
    per-image fractions, range_err_ratio a fraction of a stage's valid
    pixels; 0 for every other scalar."""
    mask = batch["mask"]
    if key.startswith("thres"):
        valid = (mask["stage4"] > 0.5).reshape(len(mask["stage4"]), -1).sum(axis=1)
        return 1.0 / (len(valid) * valid[valid > 0].min())
    if key.endswith("range_err_ratio"):
        return 1.0 / (mask[f"stage{int(key[1]) + 1}"] > 0.5).sum()
    return 0.0


def _check_scalars(got, want, what, exact=None, batch=None):
    """rtol 1e-5 (atol 1e-7); with `exact` (a float64 step's scalars) the
    tolerance also takes in want's own float32 error, |want - exact|, and
    with `batch` the pixel fractions may differ by one pixel."""
    assert got.keys() == want.keys(), what
    for key, value in want.items():
        slack = 0.0 if exact is None else abs(value - exact[key])
        slack += 0.0 if batch is None else _one_pixel(batch, key)
        assert abs(got[key] - value) <= 1e-5 * abs(value) + 1e-7 + slack, (
            what, key, got[key], value, None if exact is None else exact[key])


def _check_after(got, want, what):
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue  # flax keeps no counter
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what}: {key}")
        else:
            np.testing.assert_allclose(got[key], value, rtol=1e-2, atol=1e-5,
                                       err_msg=f"{what}: {key}")


def _check_grads(got, want, exact, single):
    """Each gradient tensor of the 2-rank step (`got`) against the float64
    step's (`exact`): e_port, its relative L2 distance, at most 10x that of
    the port's one-process float32 step (`single`), or 1e-4; and against
    JAX's 2-device step (`want`) within the two steps' summed float32
    noise, max(1e-4, 1.5 (e_port + e_jax)) (_torch_parity.check_grads'
    rule).  JAX's 2-device gradients of the narrow FPN lie up to ~5e-2 from
    the float64 ones, where its one-device step and the port's lie within
    ~1e-3."""
    from _torch_parity import GRAD_NOISE, relative_l2

    for key, e in exact.items():
        g, w = got[key], want[key]
        if np.linalg.norm(e) < GRAD_NOISE:  # zero in exact arithmetic
            np.testing.assert_allclose(g, w, atol=GRAD_NOISE, err_msg=key)
            continue
        e_port, e_jax = relative_l2(g, e), relative_l2(w, e)
        assert e_port <= max(1e-4, 10 * relative_l2(single[key], e)), (key, e_port)
        assert relative_l2(g, w) <= max(1e-4, 1.5 * (e_port + e_jax)), (
            key, relative_l2(g, w), e_port, e_jax)


def test_ranks_join_through_torchrun_env_and_start_equal(runs):
    for r, out in enumerate(runs["ranks"]):
        assert (out["rank"], out["world"], out["backend"]) == (r, WORLD, "gloo")
        # the same seed on every rank: DDP's broadcast of rank 0's state moved nothing
        assert out["broadcast_changed"] == []


def test_sgd_step_scalars_match_jax_sharded_step_and_single_process(runs):
    exact = runs["single"]["exact"]["scalars"]
    for out in runs["ranks"]:
        _check_scalars(out["step"]["scalars"], runs["jax"]["step"]["scalars"], "vs JAX", exact,
                       runs["train"])
        _check_scalars(out["step"]["scalars"], runs["single"]["step"]["scalars"],
                       "vs one process")


def test_parameters_after_the_step_match_jax_and_single_process(runs):
    """Elementwise against the port's and JAX's one-device steps and the
    float64 step; against JAX's 2-device step by gradient, within the
    float32 noise that the float64 step measures: that step's own
    parameters miss this tolerance against JAX's one-device step at a few
    elements (its float32 gradients of the narrow FPN lie ~5e-2 from the
    float64 ones)."""
    after = runs["ranks"][0]["step"]["after"]
    _check_after(after, runs["single"]["step"]["after"], "vs one process")
    _check_after(after, runs["single"]["exact"]["after"], "vs float64")
    _check_after(after, runs["jax"]["step_one_device"]["after"], "vs JAX one device")
    _check_after(after, {k: v for k, v in runs["jax"]["step"]["after"].items()
                         if k.endswith(("running_mean", "running_var"))}, "vs JAX stats")
    _check_grads(runs["ranks"][0]["step"]["grads"], runs["jax"]["step"]["grads"],
                 runs["single"]["exact"]["grads"], runs["single"]["step"]["grads"])
    moved = [k for k, v in after.items() if k.endswith("weight") and
             not np.array_equal(v, runs["sd"][k].numpy())]
    assert len(moved) > 30, moved


@pytest.mark.parametrize("case", ["step", "accum"])
def test_ranks_hold_bitwise_equal_state(runs, case):
    """Parameters and BatchNorm running statistics (broadcast_buffers=False:
    each rank's own, equal because the moments are global)."""
    a, b = (out[case]["after"] for out in runs["ranks"])
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_global_denominator_matters(runs):
    """Per-rank BatchNorm and per-rank means (plain DDP) give the mean of
    the ranks' local losses; the port's loss is the global batch's, which
    differs from it by far more than the tolerance."""
    loss = runs["ranks"][0]["step"]["scalars"]["loss"]
    per_rank = float(np.mean(runs["single"]["local_losses"]))
    _check_scalars({"loss": loss}, {"loss": runs["single"]["step"]["scalars"]["loss"]}, "loss")
    assert abs(loss - per_rank) > 1e-3 * abs(loss), (loss, per_rank)


@pytest.mark.parametrize("case,value", [("unequal", 7.0 / 6.0), ("empty", 0.5)])
def test_global_mean_value_and_gradient(runs, case, value):
    """sum of numerators / sum of counts on every rank; d/dnum = world /
    global count, which DDP's average turns into 1 / count."""
    counts = {"unequal": 6.0, "empty": 4.0}[case]
    for out in runs["ranks"]:
        got, grad = out[case]
        np.testing.assert_allclose(got, value, rtol=1e-6)
        np.testing.assert_allclose(grad, WORLD / counts, rtol=1e-6)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sinkhorn_losses_are_global_batch_means(runs, backend):
    want, want_grad = runs["ot"][backend]
    for r, out in enumerate(runs["ranks"]):
        got, grad = out["ot"][backend]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(grad / WORLD, want_grad[2 * r:2 * r + 2], rtol=1e-5,
                                   atol=1e-9)


def test_grad_accum_matches_jax_accum_step_microbatch_major(runs):
    exact = runs["single"]["exact_accum"]
    for out in runs["ranks"]:
        _check_scalars(out["accum"]["scalars"], runs["jax"]["accum"]["scalars"], "accum",
                       exact["scalars"], _microbatch_major(runs["train"]))
    after = runs["ranks"][0]["accum"]["after"]
    _check_after(after, exact["after"], "accum vs float64")
    _check_after(after, {k: v for k, v in runs["jax"]["accum"]["after"].items()
                         if k.endswith(("running_mean", "running_var"))}, "accum vs JAX stats")
    _check_grads(runs["ranks"][0]["accum"]["grads"], runs["jax"]["accum"]["grads"],
                 exact["grads"], runs["single"]["accum"]["grads"])


def test_eval_step_matches_jax_sharded_eval(runs):
    """Rank 1 has no valid pixel: it adds nothing to the global means."""
    for out in runs["ranks"]:
        _check_scalars(out["eval"], runs["jax"]["eval"], "eval")
        assert out["eval"]["abs_depth_error"] > 0


def test_train_main_rank0_writes_a_checkpoint_without_module_keys(runs):
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

    first = [out["main"]["first"] for out in runs["ranks"]]
    log = os.path.join(runs["tmp"], "log")
    path = os.path.join(log, "model_000000.ckpt")
    for r, res in enumerate(first):
        assert (res["rank"], res["world_size"], res["backend"]) == (r, WORLD, "gloo")
        assert res["steps"] == 2 and res["checkpoint"] == path  # 4 samples a shard, 2 a step
    assert runs["ranks"][0]["main"]["first_saves"] == [path + ".tmp"]
    assert runs["ranks"][1]["main"]["first_saves"] == []
    assert first[0]["val"] == first[1]["val"] and np.isfinite(first[0]["val"]["loss"])
    state = torch.load(path, weights_only=True)
    assert not any(k.startswith("module.") for k in state["model"])
    config = MVS4NetConfig(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
                           fpn_base_channel=4, reg_channel=4, attn_temp=2.0)
    MVS4Net(config).load_state_dict(state["model"], strict=True)
    # rank 0 alone logs: one record a step
    with open(os.path.join(log, "metrics.jsonl")) as f:
        modes = [json.loads(line)["mode"] for line in f]
    assert modes.count("train") == 2 + 2 and modes.count("fulltest") == 2


def test_train_main_resume_restores_on_both_ranks(runs):
    for out in runs["ranks"]:
        res = out["main"]["resumed"]
        # both ranks read epoch 0 from the checkpoint and ran epoch 1 only
        assert res["steps"] == 2
        assert res["checkpoint"].endswith("model_000001.ckpt")
    state = torch.load(runs["ranks"][0]["main"]["resumed"]["checkpoint"], weights_only=True)
    assert state["epoch"] == 1
    assert all(int(s["step"]) == 4 for s in state["optimizer"]["state"].values())


def test_train_main_rejects_a_global_batch_that_does_not_divide(runs):
    for out in runs["ranks"]:
        assert "must divide by the 2 processes" in out["main"]["odd_batch"]


def test_world_size_one_is_bitwise_the_single_device_step(monkeypatch):
    """torchrun with one process: a gloo group of one and DDP around the
    model change no bit of the step."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from _torch_parity import torch_batch
    from mvster_tpu_torch.dist.mesh import maybe_initialize_distributed
    from mvster_tpu_torch.dist.train_step import make_train_step
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.weights import init_state_dict

    train, _ = _batches()
    sd = init_state_dict(MVS4Net(MVS4NetConfig(**CFG)), seed=2)
    results = []
    for grouped in (False, True):
        model = _port_model(sd)
        if grouped:
            monkeypatch.setenv("WORLD_SIZE", "1")
            monkeypatch.setenv("RANK", "0")
            monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
            monkeypatch.setenv("MASTER_PORT", str(free_port()))
            assert maybe_initialize_distributed("cpu") == (0, 1)
        try:
            net = DistributedDataParallel(model, broadcast_buffers=False) if grouped else model
            step = make_train_step(net, torch.optim.Adam(model.parameters(), lr=LR),
                                   loss_kwargs=LOSS_KW, grad_accum=2)
            results.append((_floats(step(torch_batch(train))[0]), _state(model)))
        finally:
            if grouped:
                dist.destroy_process_group()
    (s0, a0), (s1, a1) = results
    assert s0 == s1
    for key in a0:
        np.testing.assert_array_equal(a1[key], a0[key], err_msg=key)


def test_init_raises_rather_than_run_alone_or_share_a_card(monkeypatch):
    from mvster_tpu_torch.dist import mesh

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh.maybe_initialize_distributed("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert mesh.rank_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 but 1 CUDA device"):
        mesh.rank_device("cuda")
    assert mesh.rank_device("cpu") == torch.device("cpu")


if __name__ == "__main__":
    _worker(sys.argv[1])
