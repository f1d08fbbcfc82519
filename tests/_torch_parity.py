"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX is
imported only inside the functions that need it, so the port's CUDA tests
also collect on a machine without JAX (run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_*.py`).
The test files import it as `_torch_parity` (pytest puts tests/ on sys.path),
so a package named `tests` elsewhere on the path cannot shadow it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mvster_tpu_torch.tools.weights import PROB_GAIN


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
