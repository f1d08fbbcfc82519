"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX is
imported only inside the functions that need it, so the port's CUDA tests
also collect on a machine without JAX (run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_*.py`).
The test files import it as `_torch_parity` (pytest puts tests/ on sys.path),
so a package named `tests` elsewhere on the path cannot shadow it.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvster_tpu_torch.tools.weights import ASFF_GAIN, PROB_GAIN

# pytest-xdist runs several test processes on one machine: give each its
# share of the cores, or every process's torch threads contend for all of
# them and the CPU train steps run many times slower
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


@pytest.fixture(scope="session")
def cuda_device():
    """The CUDA device, with TF32 off; skips the test where there is no card.
    Session-wide, so that a module's fixtures can build on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_wrappers():
    from mvster_tpu_torch.kernels import (conv_wgrad, deform_conv, sinkhorn_ot, warp_correlate,
                                          warp_vjp)

    return {"K1": warp_correlate.fused_cost_volume, "K2": warp_vjp.warp_gather,
            "K3": warp_vjp.scatter_grad, "K4": sinkhorn_ot.sinkhorn_fwd,
            "K5": sinkhorn_ot.sinkhorn_bwd, "K6": conv_wgrad.conv_wgrad,
            "K7": deform_conv.deform_conv}


def reset_launches():
    """Sets the launch count that each kernel wrapper keeps to 0."""
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def launches():
    """{"K1": .., "K7": ..}: each kernel wrapper's launches since
    reset_launches."""
    return {k: fn.launches for k, fn in _kernel_wrappers().items()}


@contextlib.contextmanager
def plain_warp():
    """Within: the training cost volume gathers with the plain warp (autograd
    through warp_plain) and the DCN heads take K7's plain version, which
    take any dtype: a float64 reference step on the card."""
    from mvster_tpu_torch.kernels import deform_conv, warp_vjp

    kernel, k7 = warp_vjp.grid_sample_zeros_vjp, deform_conv.deform_conv
    warp_vjp.grid_sample_zeros_vjp = warp_vjp.warp_plain
    deform_conv.deform_conv = deform_conv.deform_conv_plain
    try:
        yield
    finally:
        warp_vjp.grid_sample_zeros_vjp, deform_conv.deform_conv = kernel, k7


@contextlib.contextmanager
def plain_eval():
    """Within: the eval cost volume takes K1's plain version and the DCN
    heads K7's, which take any dtype: a float64 reference forward on the
    card."""
    from mvster_tpu_torch.kernels import deform_conv, warp_correlate

    k1, k7 = warp_correlate.fused_cost_volume, deform_conv.deform_conv
    warp_correlate.fused_cost_volume = warp_correlate.fused_cost_volume_plain
    deform_conv.deform_conv = deform_conv.deform_conv_plain
    try:
        yield
    finally:
        warp_correlate.fused_cost_volume, deform_conv.deform_conv = k1, k7


@contextlib.contextmanager
def flax_moments():
    """Within: one process's train-mode BatchNorm takes its moments as a step
    under a group of more than one rank does (nn/blocks._FlaxStats.
    _moments_forward: flax's variance E[x^2] - E[x]^2 from each channel's
    float32 sums) instead of through cuDNN, so one process rounds its
    statistics as the spatial ranks do."""
    from mvster_tpu_torch.nn import blocks

    forward = blocks._FlaxStats.forward

    def moments(self, x):
        if not self.training:
            return forward(self, x)
        x = x.to(self.weight.dtype)
        self._check_input_dim(x)
        return self._moments_forward(x)

    blocks._FlaxStats.forward = moments
    try:
        yield
    finally:
        blocks._FlaxStats.forward = forward


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(file, args, n, **env):
    """n processes of the test file `file` run as a script with `args`, each
    with torchrun's environment (RANK, WORLD_SIZE, a free MASTER_PORT) and
    `env`; the repository and tests/ on their path."""
    tests = os.path.dirname(os.path.abspath(__file__))
    base = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()),
                PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests]), **env)
    base.pop("LOCAL_RANK", None)
    return [subprocess.Popen([sys.executable, file, *args], env=dict(base, RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def wait_ranks(procs, timeout=600):
    """Waits for spawn_ranks' processes and returns their logs; raises with
    the end of its log where one failed."""
    logs = []
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-6000:]}"
    return logs


def t(x, device="cpu"):
    """numpy -> float32 torch tensor (a contiguous copy)."""
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def stage_inputs(seed, h, w, c, d, nsrc, batch=1):
    """Features, composed projections and per-pixel hypotheses for one stage.

    Returns numpy arrays: ref (B, H, W, C), src (V, B, H, W, C) unit normal;
    ref_proj (B, 4, 4), src_projs (V, B, 4, 4) composed from
    tests.helpers.synthetic_cameras; hypo (B, D, H, W), inverse-uniform over
    [425, 935] with a +-5% per-pixel jitter.
    """
    from helpers import synthetic_cameras
    from mvster_tpu_torch.core.geometry import compose_projection

    rng = np.random.default_rng(seed)
    projs = synthetic_cameras(rng, batch, nsrc + 1, h, w)["stage4"]
    comp = compose_projection(t(projs)).numpy()  # (B, V+1, 4, 4)
    ref = rng.normal(size=(batch, h, w, c)).astype(np.float32)
    src = rng.normal(size=(nsrc, batch, h, w, c)).astype(np.float32)
    itv = np.arange(d, dtype=np.float32) / (d - 1)
    inv = 1.0 / 935.0 + (1.0 / 425.0 - 1.0 / 935.0) * itv
    hypo = (1.0 / inv).astype(np.float32)[None, :, None, None] * rng.uniform(
        0.95, 1.05, size=(batch, d, h, w)
    ).astype(np.float32)
    return dict(ref=ref, src=src, ref_proj=comp[:, 0],
                src_projs=np.ascontiguousarray(np.moveaxis(comp[:, 1:], 1, 0)),
                hypo=hypo.astype(np.float32))


# the model variants of the JAX package beyond dtu_default's, by name: the
# MVS4NetConfig fields each sets (tests/test_torch_variants*.py,
# tests/test_torch_card_paths.py)
VARIANTS = {
    "reg3d": dict(reg_net="reg3d"),
    "cam": dict(agg_type="ConvBnReLU3D_CAM"),
    "dcam": dict(agg_type="ConvBnReLU3D_DCAM"),
    "pam": dict(agg_type="ConvBnReLU3D_PAM"),
    "pdam": dict(agg_type="ConvBnReLU3D_PDAM"),
    "posenc_sine": dict(pos_enc=1),
    "posenc_learned": dict(pos_enc=2),
    "asff": dict(asff=True),
    "convnext": dict(arch_mode="convnext"),
    "convnext4": dict(arch_mode="convnext4"),
    "dcn": dict(dcn=True),
    "bf16": dict(compute_dtype="bfloat16"),
}
# the variants whose image-row sharding takes more than row-local layers
# (tests/test_torch_spatial_variants*.py); ASFF at fpn_base_channel 8 on a
# narrow model, since its input channels are fixed at (64, 32, 16, 8)
BAND_VARIANTS = {k: dict(VARIANTS[k], **({"fpn_base_channel": 8} if k == "asff" else {}))
                 for k in ("reg3d", "cam", "dcam", "pam", "pdam", "asff", "convnext",
                           "convnext4", "dcn")}


def perturbed_variables(jax_model_init_shapes, seed):
    """Random flax variables {"params", "batch_stats"} as numpy, from a seed.

    `jax_model_init_shapes` is the shape tree of model.init (from
    jax.eval_shape).  Kernels are He-normal over their fan-in, biases and BN
    shifts small normals, BN scales and running variances uniform in
    [0.5, 1.5], running means small normals.  The reg2d logit heads are
    scaled by PROB_GAIN so the depth softmax is decisive and argmax
    comparisons are well conditioned, and ASFF's output norms' scales and
    shifts by ASFF_GAIN, as tools.weights.random_state_dict draws them.
    """
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.normal(size=shape) * np.sqrt(2.0 / fan_in)
                if "prob" in path:
                    a = a * PROB_GAIN
            elif k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, size=shape)
            else:  # bias, mean
                a = rng.normal(size=shape) * 0.1
            if path[-2:] == ("expand", "bn") and k in ("scale", "bias"):
                a = a * ASFF_GAIN
            out[k] = a.astype(np.float32)
        return out

    return {"params": fill(jax_model_init_shapes.get("params", {})),
            "batch_stats": fill(jax_model_init_shapes.get("batch_stats", {}))}


def jax_variables(config, sample, seed):
    """Perturbed random variables for the JAX MVS4Net(config) on `sample`."""
    import jax
    import jax.numpy as jnp

    from mvster_tpu.models import MVS4Net

    model = MVS4Net(config)
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(sample["imgs"]),
            {k: jnp.asarray(v) for k, v in sample["proj_matrices"].items()},
            jnp.asarray(sample["depth_values"]), train=False,
        )
    )
    return perturbed_variables(shapes, seed)


def jax_train_variables(config, batch, seed):
    """Perturbed random variables for the JAX MVS4Net(config) initialised in
    train mode, so the mono decoder's parameters exist when config.mono."""
    import jax
    import jax.numpy as jnp

    from mvster_tpu.models import MVS4Net

    model = MVS4Net(config)
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(batch["imgs"]),
            {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
            jnp.asarray(batch["depth_values"]), train=True,
        )
    )
    return perturbed_variables(shapes, seed)


def plane_batch(n, h=64, w=64):
    """n textured planes at depths spanning [500, 850] (inside the DTU-like
    range), with their exact GT depth and full masks: the numpy batch of
    tests/test_training_learns.py."""
    from helpers import plane_scene_sample

    parts = []
    for i in range(n):
        z = 500.0 + 350.0 * i / max(n - 1, 1)
        parts.append(plane_scene_sample(seed=100 + i, h=h, w=w, z=z))
    cat = lambda xs: np.concatenate(xs, axis=0)  # noqa: E731
    stages = list(zip(range(1, 5), [8, 4, 2, 1]))
    return {
        "imgs": cat([p["imgs"] for p in parts]),
        "proj_matrices": {k: cat([p["proj_matrices"][k] for p in parts])
                          for k in parts[0]["proj_matrices"]},
        "depth_values": cat([p["depth_values"] for p in parts]),
        "depth": {f"stage{s}": cat([np.full((1, h // sc, w // sc), p["plane_depth"],
                                            np.float32) for p in parts])
                  for s, sc in stages},
        "mask": {f"stage{s}": np.ones((n, h // sc, w // sc), np.float32)
                 for s, sc in stages},
    }


def torch_batch(batch, device="cpu"):
    """A nested numpy batch dict -> float32 tensors on `device`."""
    if isinstance(batch, dict):
        return {k: torch_batch(v, device) for k, v in batch.items()}
    return t(batch, device)


def write_dtu_tree(root, n_views=4, n_scans=1, h=128, w=160, n_refs=None, seed=0):
    """A synthetic DTU training tree in the Yao Yao layout, written with
    the port's own PFM writer (tests/test_data.py's make_dtu_tree, which
    writes through the JAX package's).

    n_views cameras on a horizontal baseline, 7 lights of h x w images,
    raw 2h x 2w depth (uniform in [450, 900]) and mask per view; pair.txt
    lists the first n_refs views (default all) as references.  The cam
    files hold quarter-resolution intrinsics (the stage-2 basis), as DTU's
    do.  At h, w = 512, 640 the loader's mid-mode crop (half-resize, then
    a 512x640 centre crop) leaves the raw maps whole.  Returns the scan
    names; `<root>/train.txt` lists them.
    """
    import os

    import cv2

    from mvster_tpu_torch.data.pfm import write_pfm

    rng = np.random.default_rng(seed)
    n_refs = n_views if n_refs is None else n_refs
    os.makedirs(f"{root}/Cameras/train", exist_ok=True)
    with open(f"{root}/Cameras/pair.txt", "w") as f:
        f.write(f"{n_refs}\n")
        for v in range(n_refs):
            srcs = [s for s in range(n_views) if s != v]
            f.write(f"{v}\n{len(srcs)} ")
            f.write(" ".join(f"{s} {100 - i}" for i, s in enumerate(srcs)) + "\n")
    for v in range(n_views):
        extr = np.eye(4)
        extr[:3, 3] = [v * 10.0, 0, 0]
        intr = np.array([[0.275 * w, 0, w / 8], [0, 0.275 * w, h / 8], [0, 0, 1]])
        with open(f"{root}/Cameras/train/{v:08d}_cam.txt", "w") as f:
            f.write("extrinsic\n")
            for row in extr:
                f.write(" ".join(map(str, row)) + "\n")
            f.write("\nintrinsic\n")
            for row in intr:
                f.write(" ".join(map(str, row)) + "\n")
            f.write("\n425.0 2.5\n")
    scans = [f"scan{i + 1}" for i in range(n_scans)]
    for scan in scans:
        os.makedirs(f"{root}/Rectified/{scan}_train", exist_ok=True)
        os.makedirs(f"{root}/Depths_raw/{scan}", exist_ok=True)
        for v in range(n_views):
            for light in range(7):
                img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
                cv2.imwrite(f"{root}/Rectified/{scan}_train/rect_{v + 1:03d}_{light}_r5000.png", img)
            depth = rng.uniform(450, 900, size=(2 * h, 2 * w)).astype(np.float32)
            write_pfm(f"{root}/Depths_raw/{scan}/depth_map_{v:04d}.pfm", depth)
            mask = (rng.uniform(size=(2 * h, 2 * w)) > 0.3).astype(np.uint8) * 255
            cv2.imwrite(f"{root}/Depths_raw/{scan}/depth_visual_{v:04d}.png", mask)
    with open(f"{root}/train.txt", "w") as f:
        f.write("\n".join(scans) + "\n")
    return scans


def write_blendedmvs_tree(root, n_views=4, h=576, w=768, seed=0):
    """A synthetic BlendedMVS tree with one scan (tests/test_loaders_extra.py's
    blended_tree, written with the port's PFM writer).

    n_views cameras on a horizontal baseline (0.2 apart, focal 400 at
    768 wide, full-resolution intrinsics as BlendedMVS's cam files hold
    them), h x w JPEG images, depth uniform in [2, 8] and the depth line
    "2.0 0.04 192 9.68", so the loader scales each scan by 100 / 2.
    pair.txt lists every view as a reference with all others as sources.
    Returns the scan name; `<root>/train.txt` lists it.
    """
    import os

    import cv2

    from mvster_tpu_torch.data.pfm import write_pfm

    rng = np.random.default_rng(seed)
    scan = "5b000000000000000000000000"
    for sub in ("blended_images", "rendered_depth_maps", "cams"):
        os.makedirs(f"{root}/{scan}/{sub}", exist_ok=True)
    with open(f"{root}/{scan}/cams/pair.txt", "w") as f:
        f.write(f"{n_views}\n")
        for v in range(n_views):
            srcs = [s for s in range(n_views) if s != v]
            f.write(f"{v}\n{len(srcs)} ")
            f.write(" ".join(f"{s} {100 - i}" for i, s in enumerate(srcs)) + "\n")
    focal = 400.0 * w / 768
    for v in range(n_views):
        img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(f"{root}/{scan}/blended_images/{v:08d}.jpg", img)
        depth = rng.uniform(2.0, 8.0, size=(h, w)).astype(np.float32)
        write_pfm(f"{root}/{scan}/rendered_depth_maps/{v:08d}.pfm", depth)
        extr = np.eye(4)
        extr[:3, 3] = [v * 0.2, 0, 0]
        intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
        with open(f"{root}/{scan}/cams/{v:08d}_cam.txt", "w") as f:
            f.write("extrinsic\n")
            for row in extr:
                f.write(" ".join(map(str, row)) + "\n")
            f.write("\nintrinsic\n")
            for row in intr:
                f.write(" ".join(map(str, row)) + "\n")
            f.write("\n2.0 0.04 192 9.68\n")
    with open(f"{root}/train.txt", "w") as f:
        f.write(scan + "\n")
    return scan


def relative_l2(got, want):
    """||got - want|| / ||want||, with 0 for two zero tensors."""
    num = float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64)))
    den = float(np.linalg.norm(np.asarray(want, np.float64)))
    return num / den if den else num


@contextlib.contextmanager
def relu_branch(masks, replay=False):
    """torch.relu (which nn.ReLU and F.relu call too) that records each
    call's side, x > 0, into the list `masks`; with `replay` it takes the
    recorded sides in call order instead of the sign of x, so a step run
    this way follows the ReLU branches of the recorded one.  Replay fails
    if the steps make a different number of calls."""
    relu = torch.relu

    def record(x):
        masks.append(x.detach() > 0)
        return relu(x)

    def apply(x):
        return x * masks.pop(0).to(x.dtype)

    torch.relu = apply if replay else record
    try:
        yield
    finally:
        torch.relu = relu
    assert not (replay and masks), f"{len(masks)} recorded ReLU calls left over"


def train_step_pair(l1ot_lw, lr=1e-3, seed=0, *, config=None, batch=None,
                    loss="mvs4net_loss", loss_kwargs=None, interpret=False,
                    branch=False):
    """One train step in both packages from the same perturbed weights; by
    default dtu_default() at 64x64, 3 views, batch 2 (two textured planes).

    `config` (MVS4NetConfig fields for both packages, default
    dtu_default()), `batch` (numpy), `loss` (the name of a loss in both
    packages' models.losses) and `loss_kwargs` (default inverse depth, 10
    Sinkhorn iterations, mono; l1ot_lw added) choose another step;
    `interpret` runs the JAX step under pltpu.force_tpu_interpret_mode(),
    so its Pallas kernels run in interpret mode on the CPU.  With `branch`
    the port's step also runs in float64 on the ReLU branches that its
    float32 step took (relu_branch): "branch_grads", the exact gradient of
    the piecewise-linear function that the float32 step differentiated.
    JAX: make_train_step(jit=True) with optax.chain(record, adam(lr)), where
    `record` keeps the step's gradients in its state.  Port: the same
    weights through tools.weights.state_dict_from_jax, make_train_step with
    torch.optim.Adam(lr).  Returns a dict of numpy: jax/port scalars, grads
    by state-dict key (the JAX ones exported through tools/convert.py),
    state dicts after the step, the JAX state before it, and the port's
    gradients of the same step run in float64 ("exact_grads").
    """
    import jax
    import jax.numpy as jnp
    import optax
    from jax.experimental.pallas import tpu as pltpu

    from mvster_tpu.dist.train_step import create_train_state
    from mvster_tpu.dist.train_step import make_train_step as jax_make_train_step
    from mvster_tpu.models import MVS4Net as JaxMVS4Net
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu.models import losses as jax_losses
    from mvster_tpu_torch.dist.train_step import make_train_step
    from mvster_tpu_torch.models import losses as port_losses
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.convert import export_state_dict
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    loss_kwargs = dict(loss_kwargs or dict(inverse_depth=True, ot_iter=10, mono=True),
                       l1ot_lw=l1ot_lw)
    batch = plane_batch(2) if batch is None else batch
    jax_config = JaxConfig.dtu_default() if config is None else JaxConfig(**config)
    port_config = (MVS4NetConfig.dtu_default() if config is None
                   else MVS4NetConfig(**config))
    jax_loss, port_loss = getattr(jax_losses, loss), getattr(port_losses, loss)
    variables = jax_train_variables(jax_config, batch, seed)

    record = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )
    tx = optax.chain(record, optax.adam(lr, b1=0.9, b2=0.999))
    jax_step = jax_make_train_step(JaxMVS4Net(jax_config), tx, loss_fn=jax_loss,
                                   loss_kwargs=loss_kwargs, donate=False)
    mode = pltpu.force_tpu_interpret_mode() if interpret else contextlib.nullcontext()
    with mode:
        state, jax_scalars, _ = jax_step(create_train_state(variables, tx),
                                         jax.tree_util.tree_map(jnp.asarray, batch))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jax_after = export_state_dict({"params": to_np(state.params),
                                   "batch_stats": to_np(state.batch_stats)})
    jax_grads = export_state_dict({"params": to_np(state.opt_state[0])})

    model = MVS4Net(port_config)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    masks = []
    with relu_branch(masks) if branch else contextlib.nullcontext():
        port_scalars, _ = make_train_step(model, optimizer, port_loss, loss_kwargs)(
            torch_batch(batch))

    # the same step in float64 (the Sinkhorn stays float32, as in both
    # packages): the exact gradient that both float32 gradients approximate
    f64 = lambda x: ({k: f64(v) for k, v in x.items()} if isinstance(x, dict)  # noqa: E731
                     else torch.from_numpy(np.asarray(x, np.float64)))

    def float64_grads(context):
        exact = MVS4Net(port_config)
        exact.load_state_dict(state_dict_from_jax(variables), strict=True)
        exact.double()
        with context:
            make_train_step(exact, torch.optim.SGD(exact.parameters(), lr=0.0), port_loss,
                            loss_kwargs)(f64(batch))
        return _grads(exact)

    extra = {"branch_grads": float64_grads(relu_branch(masks, replay=True))} if branch else {}
    return {
        "jax_scalars": {k: float(v) for k, v in jax_scalars.items()},
        "port_scalars": {k: float(v) for k, v in port_scalars.items()},
        "jax_grads": jax_grads,
        "port_grads": _grads(model),
        "exact_grads": float64_grads(contextlib.nullcontext()),
        "jax_after": jax_after,
        "port_after": {k: v.numpy().copy() for k, v in model.state_dict().items()},
        "before": export_state_dict(variables),
        **extra,
    }


def _grads(model):
    """Each parameter's gradient as numpy; zeros where none reached it (a
    parameter upstream of an sg_cuts cut)."""
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
            for k, p in model.named_parameters()}


# gradients whose float64 norm is below this are zero in exact arithmetic
# (the logit heads' biases: the depth softmax is shift-invariant) and hold
# float noise in both packages, so they are compared in absolute terms
GRAD_NOISE = 1e-6


def check_scalars(step, rtol=1e-5):
    jax_s, port_s = step["jax_scalars"], step["port_scalars"]
    assert port_s.keys() == jax_s.keys()
    for key, want in jax_s.items():
        np.testing.assert_allclose(port_s[key], want, rtol=rtol, atol=1e-7, err_msg=key)


def check_grads(step, mono_zero):
    """Each gradient tensor against JAX's, with float32 noise measured.

    At 64x64 the backward through stage 4's Reg2d amplifies float32
    rounding: both packages' float32 gradients of its layers and of the
    FPN below lie up to ~1e-2 (relative L2) from the float64 gradient of
    the same step, and how far depends on the summation order (the CPU's
    thread count).  So besides JAX's gradient the port's step also runs in
    float64, and with e_jax and e_port the relative L2 distances of JAX's
    and the port's float32 gradients from that float64 gradient, each
    tensor must have e_jax <= max(1e-4, 30 e_port) (JAX computes the
    gradient of the port's function, to within float32 noise; JAX's own
    float32 gradient is up to ~10x noisier than the port's in some tensors),
    e_port <= max(1e-4, 10 e_jax) (the port's float32 gradient is as good as
    JAX's), e_jax <= 5e-2, and port vs JAX <= max(1e-4, 1.5 (e_port + e_jax)).
    """
    jax_g, port_g, exact_g = step["jax_grads"], step["port_grads"], step["exact_grads"]
    assert port_g.keys() == jax_g.keys() == exact_g.keys()
    for key, want in jax_g.items():
        got, exact = port_g[key], exact_g[key]
        if key.startswith("mono_depth_decoder.") and mono_zero:
            assert not np.any(got) and not np.any(want), key
            continue
        if np.linalg.norm(exact) < GRAD_NOISE:
            np.testing.assert_allclose(got, want, atol=GRAD_NOISE, err_msg=key)
            continue
        e_jax, e_port = relative_l2(want, exact), relative_l2(got, exact)
        assert e_jax <= 5e-2, (key, e_jax)
        assert e_jax <= max(1e-4, 30 * e_port), (key, e_jax, e_port)
        assert e_port <= max(1e-4, 10 * e_jax), (key, e_port, e_jax)
        assert relative_l2(got, want) <= max(1e-4, 1.5 * (e_port + e_jax)), (
            key, relative_l2(got, want), e_port, e_jax)


def check_grads_by_branch(step, rtol=1e-3):
    """Each gradient tensor against a float64 gradient of the port's step
    (train_step_pair with branch=True), for a model narrow enough that a
    float32 forward can land on the other side of a ReLU's kink.

    At the narrow config of tests/test_blend_train.py (fpn_base_channel =
    reg_channel = 4) one pre-activation within float32 rounding of 0 moves
    the float32 gradients below it ~1e-2 (relative L2) from float64, in
    either package, and which side each float32 forward takes is chance.
    So JAX's float32 gradient is held to the float64 step's ("exact_grads",
    the gradient of the port's function), and the port's to the float64
    step on the ReLU branches of its own float32 step ("branch_grads"):
    each within relative L2 `rtol`; gradients under GRAD_NOISE at atol
    GRAD_NOISE.
    """
    jax_g, port_g = step["jax_grads"], step["port_grads"]
    assert port_g.keys() == jax_g.keys() == step["branch_grads"].keys()
    for got, exact in ((jax_g, step["exact_grads"]), (port_g, step["branch_grads"])):
        for key, want in exact.items():
            if np.linalg.norm(want) < GRAD_NOISE:
                np.testing.assert_allclose(got[key], want, atol=GRAD_NOISE, err_msg=key)
            else:
                assert relative_l2(got[key], want) <= rtol, (key, relative_l2(got[key], want))


def check_variant_grads(step):
    """The gradients of a variant's train step (train_step_pair with
    branch=True; tests/test_torch_variants_train*.py say why): the port's
    within relative L2 2e-3 of its float64 step on its own float32 ReLU
    branches, each tensor; JAX's within 0.15 of the nearer of the port's
    two float64 gradients, each tensor, and within 2e-4 in the median;
    gradients under GRAD_NOISE at atol GRAD_NOISE."""
    jax_g, port_g = step["jax_grads"], step["port_grads"]
    exact, branch = step["exact_grads"], step["branch_grads"]
    assert port_g.keys() == jax_g.keys() == exact.keys() == branch.keys()
    jax_err = []
    for key, want in exact.items():
        if np.linalg.norm(want) < GRAD_NOISE:
            np.testing.assert_allclose(jax_g[key], want, atol=GRAD_NOISE, err_msg=key)
            np.testing.assert_allclose(port_g[key], want, atol=GRAD_NOISE, err_msg=key)
            continue
        assert relative_l2(port_g[key], branch[key]) <= 2e-3, (
            key, relative_l2(port_g[key], branch[key]))
        e = min(relative_l2(jax_g[key], want), relative_l2(jax_g[key], branch[key]))
        assert e <= 0.15, (key, e)
        jax_err.append(e)
    assert np.median(jax_err) <= 2e-4, np.median(jax_err)


def check_after(step, lr=1e-3, stats_rtol=0.0):
    """State after the step: BatchNorm running statistics at atol 1e-5
    (and rtol `stats_rtol`);
    parameters as Adam's first step on the port's own gradients
    (p - lr * g / (|g| + eps), atol 1e-7 plus two float32 ulps of p, as
    optax computes it from JAX's),
    and equal to JAX's updated parameters at atol 1e-6 wherever |g_jax| >=
    1e-6 and the two gradients agree to 10% (there the update differs by
    under lr * 1e-8 / |g| * 10%).  Elsewhere float32 noise sets the sign of
    the update (see check_grads); those elements must be under 1% of the
    parameters."""
    jax_a, port_a = step["jax_after"], step["port_after"]
    assert port_a.keys() == jax_a.keys()
    compared = total = 0
    for key, want in jax_a.items():
        got = port_a[key]
        if key.endswith("num_batches_tracked"):
            continue  # flax keeps no counter; the port counts train forwards
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, rtol=stats_rtol, atol=1e-5, err_msg=key)
            continue
        before = step["before"][key]
        g_jax, g_port = step["jax_grads"][key], step["port_grads"][key]
        for new, g in ((got, g_port), (want, g_jax)):
            np.testing.assert_allclose(new, before - lr * g / (np.abs(g) + 1e-8),
                                       rtol=2.4e-7, atol=1e-7, err_msg=key)
        big = np.abs(g_jax) >= 1e-6
        agree = big & (np.abs(g_port - g_jax) <= 0.1 * np.abs(g_jax))
        np.testing.assert_allclose(got[agree], want[agree], rtol=0, atol=1e-6, err_msg=key)
        compared += int(agree.sum())
        total += int(big.sum())
    assert compared >= 0.99 * total, (compared, total)


def run_jax_model(config, variables, sample):
    """The JAX eval forward, jitted on the CPU -> nested dict of numpy."""
    import jax
    import jax.numpy as jnp

    from mvster_tpu.models import MVS4Net

    model = MVS4Net(config)
    out = jax.jit(lambda v, i, p, d: model.apply(v, i, p, d, train=False))(
        variables, jnp.asarray(sample["imgs"]),
        {k: jnp.asarray(v) for k, v in sample["proj_matrices"].items()},
        jnp.asarray(sample["depth_values"]),
    )
    return jax.tree_util.tree_map(np.asarray, out)


def to_numpy_tree(out):
    """The port's output dict (tensors, ints) -> the same dict of numpy."""
    if isinstance(out, dict):
        return {k: to_numpy_tree(v) for k, v in out.items()}
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


# Reg2d's receptive-field radius in pixels at its stage's resolution: three
# stride-2 (1,3,3) convs and 3x3x3 blocks down, three transposed convs up
# (1 + 1 + 2 + 2 + 4 + 4 + 8 + 8 + 4 + 2 = 36)
REG2D_RADIUS = 36


def _dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    """(B, H, W) bool mask grown by a (2r+1)^2 box (a column max, then a
    row max)."""
    m = torch.from_numpy(mask[:, None].astype(np.float32))
    k = 2 * radius + 1
    m = torch.nn.functional.max_pool2d(m, (k, 1), 1, (radius, 0))
    return torch.nn.functional.max_pool2d(m, (1, k), 1, (0, radius))[:, 0].numpy() > 0


def assert_stage_close(ref_out, our_out, atol=2e-3, num_stage=4):
    """Stage-by-stage comparison that tracks cascade-tie divergence.

    Both arguments are nested numpy dicts of an eval forward.  Argmax at
    near-flat pixels is float noise in either package, and a flipped argmax
    moves the next stage's hypothesis window at that pixel and, through the
    trilinear upsampling, at its neighbours; through Reg2d's receptive field
    the moved window then changes the logits of every pixel within
    REG2D_RADIUS of it.  So each stage is compared only where no hypothesis
    window within REG2D_RADIUS disagrees beyond rtol 1e-5 (an unflipped
    window differs by float rounding only, ~1e-7), and that region must
    cover 90% of the pixels: attention at `atol`, the expected depth at
    rtol 5e-3, and the argmax depth, with at most 1% mismatches, on pixels
    where the reference's top two probabilities differ by more than 0.05.
    `num_stage` stages are compared (the config's), the last one also as
    the top-level depth.
    """
    for s in range(1, num_stage + 1):
        key = f"stage{s}"
        ref_attn = ref_out[key]["attn_weight"]
        our_attn = our_out[key]["attn_weight"]
        ref_hypo = ref_out[key]["hypo_depth"]
        our_hypo = our_out[key]["hypo_depth"]
        assert our_attn.shape == ref_attn.shape, (key, our_attn.shape, ref_attn.shape)

        agree = np.all(np.isclose(our_hypo, ref_hypo, rtol=1e-5), axis=1)
        valid = ~_dilate(~agree, REG2D_RADIUS)
        assert valid.mean() > 0.9, (
            f"{key}: only {valid.mean():.2%} of hypothesis windows agree"
        )
        vmask = np.broadcast_to(valid[:, None], ref_attn.shape)
        np.testing.assert_allclose(
            our_attn[vmask], ref_attn[vmask], atol=atol,
            err_msg=f"{key} attn_weight mismatch (valid pixels)",
        )
        ref_exp = (ref_attn * ref_hypo).sum(1)
        our_exp = (our_attn * our_hypo).sum(1)
        np.testing.assert_allclose(
            our_exp[valid], ref_exp[valid], rtol=5e-3, atol=1e-2,
            err_msg=f"{key} expected-depth mismatch",
        )
        top2 = np.sort(ref_attn, axis=1)[:, -2:]
        decisive = ((top2[:, 1] - top2[:, 0]) > 0.05) & valid
        mismatch = ~np.isclose(our_out[key]["depth"], ref_out[key]["depth"],
                               rtol=1e-3, atol=1e-2)
        frac = mismatch[decisive].mean() if decisive.any() else 0.0
        assert frac <= 0.01, f"{key} decisive-pixel depth mismatch {frac}"
    np.testing.assert_allclose(our_out["depth"], our_out[f"stage{num_stage}"]["depth"])


def assert_bf16_close(ref_out, our_out):
    """Two eval forwards with compute_dtype "bfloat16" (or one against a
    float32 forward), by tests/test_bf16.py's criteria for the JAX
    package's bf16 forward against its float32 one: stage-1 attention
    within 0.02 on average, and over 70% of the final depths within 2%.
    One bf16 rounding apart at a conv grows layer by layer and, through
    the argmax, moves later stages' hypothesis windows, so
    assert_stage_close's float32 criteria do not hold here."""
    attn = np.abs(our_out["stage1"]["attn_weight"] - ref_out["stage1"]["attn_weight"]).mean()
    assert attn < 0.02, f"stage-1 attention {attn} apart on average"
    agree = np.mean(np.abs(our_out["depth"] - ref_out["depth"]) / ref_out["depth"] < 0.02)
    assert agree > 0.7, f"only {agree:.2%} of the final depths within 2%"
    assert np.isfinite(our_out["depth"]).all()


# ---- the serving path: scans on disk, the DTU ground truth, fusion's edges

def _write_cam(path, extr, intr, depth_line):
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in extr:
            f.write(" ".join(map(str, row)) + "\n")
        f.write("\nintrinsic\n")
        for row in intr:
            f.write(" ".join(map(str, row)) + "\n")
        f.write(f"\n{depth_line}\n")


def _write_pair(path, n_views):
    """Every view a reference, every other view a source."""
    with open(path, "w") as f:
        f.write(f"{n_views}\n")
        for v in range(n_views):
            srcs = [s for s in range(n_views) if s != v]
            f.write(f"{v}\n{len(srcs)} ")
            f.write(" ".join(f"{s} {100 - i}" for i, s in enumerate(srcs)) + "\n")


def plane_baselines(n_views, baseline):
    """x offsets of the source cameras: +b, -b, +2b, -2b, ..."""
    return tuple(baseline * (i // 2 + 1) * (1 if i % 2 == 0 else -1)
                 for i in range(n_views - 1))


def write_plane_scan(root, scan="scan1", n_views=3, h=128, w=128, z=600.0,
                     baseline=300.0):
    """A DTU test scan (general_eval layout: images/, cams/ with full-size
    intrinsics and the depth line "425.0 2.66", pair.txt listing every
    other view as a source) of tests/helpers.plane_scene_sample's textured
    plane at depth z, the cameras offset along x by plane_baselines.  At 3
    views and the defaults it is scripts/smoke_test_cli.write_scan's scan,
    written without JAX.  Returns (scan, K (3, 3), [extrinsics (4, 4)]).
    """
    import cv2

    from helpers import plane_scene_sample

    sample = plane_scene_sample(0, h=h, w=w, z=z,
                                baselines=plane_baselines(n_views, baseline))
    imgs = sample["imgs"][0]
    imgs = (imgs - imgs.min()) / (imgs.max() - imgs.min())
    os.makedirs(f"{root}/{scan}/images", exist_ok=True)
    os.makedirs(f"{root}/{scan}/cams", exist_ok=True)
    projs = sample["proj_matrices"]["stage4"][0]  # full-size K
    for v in range(n_views):
        cv2.imwrite(f"{root}/{scan}/images/{v:08d}.jpg",
                    cv2.cvtColor((imgs[v] * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
        _write_cam(f"{root}/{scan}/cams/{v:08d}_cam.txt", projs[v, 0],
                   projs[v, 1, :3, :3], "425.0 2.66")
    _write_pair(f"{root}/{scan}/pair.txt", n_views)
    return scan, projs[0, 1, :3, :3].copy(), [projs[v, 0].copy() for v in range(n_views)]


def plane_gt_points(intr, extrs, h, w, z, spacing, min_views=1):
    """Ground truth for a plane scan: points of the world plane at depth z on
    a grid of `spacing` over what at least min_views of the fronto-parallel
    cameras (intr (3, 3), world-to-camera extrs) see of it, as (N, 3)
    float32."""
    intr = np.asarray(intr, np.float64)
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
                       np.float64).T
    cam = np.linalg.inv(intr) @ corners * z
    world = np.concatenate([
        (np.linalg.inv(np.asarray(e, np.float64)) @ np.vstack([cam, np.ones(4)]))[:2]
        for e in extrs], axis=1)
    xs = np.arange(world[0].min(), world[0].max() + spacing, spacing)
    ys = np.arange(world[1].min(), world[1].max() + spacing, spacing)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], 1)
    seen = np.zeros(len(pts), np.int64)
    for e in extrs:
        p = intr @ (np.asarray(e, np.float64)[:3, :3] @ pts.T + np.asarray(e, np.float64)[:3, 3:])
        u, v = p[0] / p[2], p[1] / p[2]
        seen += (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    return pts[seen >= min_views].astype(np.float32)


def write_dtu_gt_tree(gt_dir, scan_id, stl, res=4.0):
    """A DTU SampleSet "MVS Data" tree for one scan: Points/stl/stl<id>_total.ply
    (the (N, 3) ground-truth cloud), ObsMask/ObsMask<id>_10.mat (every voxel
    of res mm over the cloud's box, grown by 10 mm, observed) and
    ObsMask/Plane<id>.mat (a ground plane 50 mm beyond the deepest point, so
    every ground-truth point lies above it), written with scipy.io.savemat."""
    from scipy.io import savemat

    from mvster_tpu_torch.infer.ply import write_ply

    os.makedirs(f"{gt_dir}/Points/stl", exist_ok=True)
    os.makedirs(f"{gt_dir}/ObsMask", exist_ok=True)
    write_ply(f"{gt_dir}/Points/stl/stl{scan_id:03d}_total.ply", stl)
    bb = np.stack([stl.min(0) - 10.0, stl.max(0) + 10.0]).astype(np.float64)
    dims = tuple(int(n) for n in np.ceil((bb[1] - bb[0]) / res) + 1)
    savemat(f"{gt_dir}/ObsMask/ObsMask{scan_id}_10.mat",
            {"ObsMask": np.ones(dims, np.uint8), "BB": bb, "Res": np.float64(res)})
    savemat(f"{gt_dir}/ObsMask/Plane{scan_id}.mat",
            {"P": np.array([[0.0], [0.0], [-1.0], [float(stl[:, 2].max()) + 50.0]])})


def write_tanks_tree(root, split="intermediate", n_views=3, h=1080, w=1920, seed=0):
    """A Tanks and Temples tree (`<split>/<scan>/` with images/, cams/ and
    pair.txt) holding every scan of the split, each n_views views of
    tests/helpers.plane_scene_sample's textured plane at depth 600 (one
    rendering shared by the scans), full-size intrinsics and the depth line
    "425.0 2.66 192 935.72".  Returns the split's scans."""
    import cv2

    from helpers import plane_scene_sample
    from mvster_tpu_torch.data.tanks import ADVANCED, INTERMEDIATE

    sample = plane_scene_sample(seed, h=h, w=w, z=600.0,
                                baselines=plane_baselines(n_views, 40.0))
    imgs = sample["imgs"][0]
    imgs = (255 * (imgs - imgs.min()) / (imgs.max() - imgs.min())).astype(np.uint8)
    projs = sample["proj_matrices"]["stage4"][0]
    scans = INTERMEDIATE if split == "intermediate" else ADVANCED
    for scan in scans:
        d = f"{root}/{split}/{scan}"
        os.makedirs(f"{d}/images", exist_ok=True)
        os.makedirs(f"{d}/cams", exist_ok=True)
        for v in range(n_views):
            cv2.imwrite(f"{d}/images/{v:08d}.jpg", cv2.cvtColor(imgs[v], cv2.COLOR_RGB2BGR))
            _write_cam(f"{d}/cams/{v:08d}_cam.txt", projs[v, 0], projs[v, 1, :3, :3],
                       "425.0 2.66 192 935.72")
        _write_pair(f"{d}/pair.txt", n_views)
    return scans


def write_eth3d_tree(root, n_views=2, h=120, w=192, seed=0):
    """An ETH3D tree (`<scan>/` with images/, cams_1/ and pair.txt) holding
    every test scan: n_views random h x w images a scan, cameras on a 0.2
    baseline, and depth lines whose minimum is negative in even scans (the
    loader clamps it to 1) and positive in odd ones.  Returns the scans."""
    import cv2

    from mvster_tpu_torch.data.eth3d import TEST_SCANS

    rng = np.random.default_rng(seed)
    focal = 1.5 * w
    for i, scan in enumerate(TEST_SCANS):
        os.makedirs(f"{root}/{scan}/images", exist_ok=True)
        os.makedirs(f"{root}/{scan}/cams_1", exist_ok=True)
        _write_pair(f"{root}/{scan}/pair.txt", n_views)
        for v in range(n_views):
            cv2.imwrite(f"{root}/{scan}/images/{v:08d}.jpg",
                        (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8))
            extr = np.eye(4)
            extr[:3, 3] = [v * 0.2, 0, 0]
            intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
            line = "-1.0 0.01 192 5.0" if i % 2 == 0 else "1.5 0.01 192 5.0"
            _write_cam(f"{root}/{scan}/cams_1/{v:08d}_cam.txt", extr, intr, line)
    return TEST_SCANS


FUSION_EDGE = 1e-4  # px and relative depth: a pixel this close to a threshold may flip


def fusion_edge_pixels(ref_depth, ref_intr, ref_extr, src_depths, src_intrs, src_extrs,
                       dist_thresh=1.0, rel_depth_thresh=0.01, margin=FUSION_EDGE):
    """(H, W) bool numpy: the pixels where some source's reprojection distance
    or relative depth difference lies within `margin` of its threshold, by
    the port's reprojection on the CPU (torch tensors or numpy in)."""
    from mvster_tpu_torch.infer.fusion import reprojection_errors

    args = [torch.as_tensor(np.asarray(x, np.float32)) for x in
            (ref_depth, ref_intr, ref_extr, src_depths, src_intrs, src_extrs)]
    _, dist, rel = reprojection_errors(*args)
    near = ((dist - dist_thresh).abs() < margin) | ((rel - rel_depth_thresh).abs() < margin)
    return near.any(0).numpy()


def assert_masks_agree(got, want, edge, what=""):
    """Boolean maps equal but at edge pixels; returns the pixels that differ."""
    got, want = np.asarray(got), np.asarray(want)
    differ = got != want
    off_edge = differ & ~edge
    assert not off_edge.any(), f"{what}: {int(off_edge.sum())} pixels differ off the edge"
    return int(differ.sum())
