"""Weights for the port's MVS4Net: from the JAX package, from a released checkpoint, or random.

All three give a state dict in the reference MVSTER key grammar, which
`MVS4Net.load_state_dict(..., strict=True)` accepts as it is.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mvster_tpu_torch.config import MVS4NetConfig

MONO_PREFIX = "mono_depth_decoder."
PROB_GAIN = 10.0  # random_state_dict's scale of the logit heads


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """numpy flax variables {"params", "batch_stats"} -> torch state dict.

    Goes through the JAX package's numpy-only exporter, which already
    inverts the layouts (conv HWIO -> OIHW, the pre-flipped transposed
    conv back to IODHW).
    """
    from mvster_tpu.tools.convert_torch_ckpt import export_state_dict

    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in export_state_dict(variables).items()}


def load_reference_ckpt(path: str, config: MVS4NetConfig) -> dict[str, torch.Tensor]:
    """Read a released MVSTER .ckpt (or a saved state dict) for `config`.

    Accepts {"model": state_dict, ...} or a bare state dict, strips a
    DataParallel "module." prefix, and drops the mono decoder's keys (by
    that prefix only) when config.mono is False: the decoder serves
    training only.
    """
    state = torch.load(path, map_location="cpu", weights_only=True)
    sd = state.get("model", state)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if not config.mono:
        sd = {k: v for k, v in sd.items() if not k.startswith(MONO_PREFIX)}
    return sd


def random_state_dict(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights for every entry of model.state_dict().

    Conv kernels are He-normal over their fan-in, biases and BN shifts
    small normals, BN scales and running variances uniform in [0.5, 1.5],
    running means small normals.  The reg2d logit heads (`reg.*.prob`) are
    scaled by PROB_GAIN, so the depth softmax is decisive rather than
    near-uniform.  Made on the CPU from a torch.Generator, so a seed gives
    the same weights on every device.
    """
    gen = torch.Generator().manual_seed(seed)
    # transposed convs keep (in, out, ...) weights, the others (out, in, ...)
    transposed = {f"{name}.weight" for name, m in model.named_modules()
                  if isinstance(m, torch.nn.modules.conv._ConvTransposeNd)}
    out = {}
    for key, ref in model.state_dict().items():
        shape = ref.shape
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros_like(ref)
            continue
        if leaf == "weight" and ref.dim() > 1:
            fan_in = ref[:, 0].numel() if key in transposed else ref[0].numel()
            val = torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5
            if ".prob." in key:
                val = val * PROB_GAIN
        elif leaf in ("running_var",) or (leaf == "weight" and ref.dim() == 1):
            val = 0.5 + torch.rand(shape, generator=gen)
        else:  # bias, running_mean
            val = 0.1 * torch.randn(shape, generator=gen)
        out[key] = val.to(ref.dtype)
    return out
