"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX is
imported only inside the functions that need it, so the port's CUDA tests
also collect on a machine without JAX (run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_*.py`).
The test files import it as `_torch_parity` (pytest puts tests/ on sys.path),
so a package named `tests` elsewhere on the path cannot shadow it.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from mvster_tpu_torch.tools.weights import PROB_GAIN

# pytest-xdist runs several test processes on one machine: give each its
# share of the cores, or every process's torch threads contend for all of
# them and the CPU train steps run many times slower
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


@pytest.fixture
def cuda_device():
    """The CUDA device, with TF32 off; skips the test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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


def perturbed_variables(jax_model_init_shapes, seed):
    """Random flax variables {"params", "batch_stats"} as numpy, from a seed.

    `jax_model_init_shapes` is the shape tree of model.init (from
    jax.eval_shape).  Kernels are He-normal over their fan-in, biases and BN
    shifts small normals, BN scales and running variances uniform in
    [0.5, 1.5], running means small normals.  The reg2d logit heads are
    scaled by PROB_GAIN so the depth softmax is decisive and argmax
    comparisons are well conditioned.
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
            out[k] = a.astype(np.float32)
        return out

    return {"params": fill(jax_model_init_shapes["params"]),
            "batch_stats": fill(jax_model_init_shapes["batch_stats"])}


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


def relative_l2(got, want):
    """||got - want|| / ||want||, with 0 for two zero tensors."""
    num = float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64)))
    den = float(np.linalg.norm(np.asarray(want, np.float64)))
    return num / den if den else num


def train_step_pair(l1ot_lw, lr=1e-3, seed=0):
    """One train step of dtu_default() at 64x64, 3 views, batch 2 (two
    textured planes), in both packages from the same perturbed weights.

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

    from mvster_tpu.dist.train_step import create_train_state
    from mvster_tpu.dist.train_step import make_train_step as jax_make_train_step
    from mvster_tpu.models import MVS4Net as JaxMVS4Net
    from mvster_tpu.models import MVS4NetConfig as JaxConfig
    from mvster_tpu_torch.dist.train_step import make_train_step
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.convert import export_state_dict
    from mvster_tpu_torch.tools.weights import state_dict_from_jax

    loss_kwargs = dict(inverse_depth=True, ot_iter=10, mono=True, l1ot_lw=l1ot_lw)
    batch = plane_batch(2)
    variables = jax_train_variables(JaxConfig.dtu_default(), batch, seed)

    record = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )
    tx = optax.chain(record, optax.adam(lr, b1=0.9, b2=0.999))
    jax_step = jax_make_train_step(JaxMVS4Net(JaxConfig.dtu_default()), tx,
                                   loss_kwargs=loss_kwargs, donate=False)
    state, jax_scalars, _ = jax_step(create_train_state(variables, tx),
                                     jax.tree_util.tree_map(jnp.asarray, batch))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jax_after = export_state_dict({"params": to_np(state.params),
                                   "batch_stats": to_np(state.batch_stats)})
    jax_grads = export_state_dict({"params": to_np(state.opt_state[0])})

    model = MVS4Net(MVS4NetConfig.dtu_default())
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    port_scalars, _ = make_train_step(model, optimizer, loss_kwargs=loss_kwargs)(
        torch_batch(batch))

    # the same step in float64 (the Sinkhorn stays float32, as in both
    # packages): the exact gradient that both float32 gradients approximate
    exact = MVS4Net(MVS4NetConfig.dtu_default())
    exact.load_state_dict(state_dict_from_jax(variables), strict=True)
    exact.double()
    f64 = lambda x: ({k: f64(v) for k, v in x.items()} if isinstance(x, dict)  # noqa: E731
                     else torch.from_numpy(np.asarray(x, np.float64)))
    make_train_step(exact, torch.optim.SGD(exact.parameters(), lr=0.0),
                    loss_kwargs=loss_kwargs)(f64(batch))
    return {
        "jax_scalars": {k: float(v) for k, v in jax_scalars.items()},
        "port_scalars": {k: float(v) for k, v in port_scalars.items()},
        "jax_grads": jax_grads,
        "port_grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
        "exact_grads": {k: p.grad.numpy().copy() for k, p in exact.named_parameters()},
        "jax_after": jax_after,
        "port_after": {k: v.numpy().copy() for k, v in model.state_dict().items()},
        "before": export_state_dict(variables),
    }


# gradients whose float64 norm is below this are zero in exact arithmetic
# (the logit heads' biases: the depth softmax is shift-invariant) and hold
# float noise in both packages, so they are compared in absolute terms
GRAD_NOISE = 1e-6


def check_scalars(step):
    jax_s, port_s = step["jax_scalars"], step["port_scalars"]
    assert port_s.keys() == jax_s.keys()
    for key, want in jax_s.items():
        np.testing.assert_allclose(port_s[key], want, rtol=1e-5, atol=1e-7, err_msg=key)


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


def check_after(step, lr=1e-3):
    """State after the step: BatchNorm running statistics at atol 1e-5;
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
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=key)
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
    """(B, H, W) bool mask grown by a (2r+1)^2 box."""
    m = torch.from_numpy(mask[:, None].astype(np.float32))
    return torch.nn.functional.max_pool2d(m, 2 * radius + 1, 1, radius)[:, 0].numpy() > 0


def assert_stage_close(ref_out, our_out, atol=2e-3):
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
    """
    for s in range(1, 5):
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
    np.testing.assert_allclose(our_out["depth"], our_out["stage4"]["depth"])
