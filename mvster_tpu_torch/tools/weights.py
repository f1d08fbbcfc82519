"""Weights for the port's MVS4Net: from flax variables, from a released checkpoint, or drawn from a seed.

Each gives a state dict in the reference MVSTER key grammar, which
`MVS4Net.load_state_dict(..., strict=True)` accepts as it is:
state_dict_from_jax (numpy flax variables, through tools/convert.py),
load_reference_ckpt, init_state_dict (training's initial weights, drawn
as flax draws them) and random_state_dict (decisive random weights for
tests and smoke runs).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mvster_tpu_torch.config import MVS4NetConfig

MONO_PREFIX = "mono_depth_decoder."
PROB_GAIN = 10.0  # random_state_dict's scale of the logit heads
# random_state_dict's scale of ASFF's output norms (`asff.*.expand.bn`): the
# fused features then keep the FPN heads' magnitude, where unscaled they run
# ~5x larger and the cost volume, their product, ~20x
ASFF_GAIN = 0.25


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """numpy flax variables {"params", "batch_stats"} -> torch state dict.

    Goes through the port's numpy exporter (tools/convert.py), which
    inverts the layouts (conv HWIO -> OIHW, the pre-flipped transposed
    conv back to IODHW).
    """
    from mvster_tpu_torch.tools.convert import export_state_dict

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


def init_state_dict(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Initial training weights for every entry of model.state_dict(), drawn
    as the JAX package's flax modules draw theirs.

    Convolutions, Linear layers and the DCN tap kernel: LeCun normal
    truncated at two standard deviations over the fan-in (flax's default),
    zero biases; DCN's offset and modulation convs: zeros (the identity
    deformation); transposed convolutions: normal with variance 1/fan-in,
    the fan-in taken over (I, kd, kh, kw) as the JAX package's kernel is
    laid out; BatchNorm and LayerNorm: scale 1, shift 0, running mean 0,
    running variance 1; the ConvNeXt layer scale: its 1e-6; the learned
    depth embeddings: uniform in [0, 1).  Made on the CPU from a
    torch.Generator, so a seed gives the same weights on every device.
    """
    from mvster_tpu_torch.nn.dcn import DeformConv2d

    gen = torch.Generator().manual_seed(seed)
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def lecun(key):
        w = out[key]  # (O, I, *k) or (O, I)
        std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
        out[key] = torch.nn.init.trunc_normal_(
            torch.empty(w.shape), std=std, a=-2 * std, b=2 * std, generator=gen)

    zero = set()
    for name, m in model.named_modules():
        if isinstance(m, DeformConv2d):
            lecun(f"{name}.weight")
            zero.update((f"{name}.p_conv", f"{name}.m_conv"))
            continue
        if name in zero:
            out[f"{name}.weight"] = torch.zeros_like(out[f"{name}.weight"])
        elif isinstance(m, torch.nn.modules.conv._ConvTransposeNd):
            w = out[f"{name}.weight"]  # (I, O, *k)
            std = (1.0 / w[:, 0].numel()) ** 0.5
            out[f"{name}.weight"] = torch.randn(w.shape, generator=gen) * std
        elif isinstance(m, (torch.nn.modules.conv._ConvNd, torch.nn.Linear)):
            lecun(f"{name}.weight")
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            out[f"{name}.weight"] = torch.ones_like(out[f"{name}.weight"])
            for key in ("bias", "running_mean", "num_batches_tracked"):
                out[f"{name}.{key}"] = torch.zeros_like(out[f"{name}.{key}"])
            out[f"{name}.running_var"] = torch.ones_like(out[f"{name}.running_var"])
            continue
        elif isinstance(m, torch.nn.LayerNorm):
            out[f"{name}.weight"] = torch.ones_like(out[f"{name}.weight"])
        else:
            continue
        if getattr(m, "bias", None) is not None:
            out[f"{name}.bias"] = torch.zeros_like(out[f"{name}.bias"])
    for key in out:
        if key.startswith("pos_enc_func."):
            out[key] = torch.rand(out[key].shape, generator=gen)
    return out


def random_state_dict(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights for every entry of model.state_dict().

    Conv kernels are He-normal over their fan-in, biases and BN shifts
    small normals, BN scales and running variances uniform in [0.5, 1.5],
    running means small normals; LayerNorm scales as BatchNorm's, around
    1; the ConvNeXt layer scales `gamma` and the learned depth embeddings
    small normals, as biases.  The regularisers' logit heads (`reg.*.prob`,
    Reg2d's and Reg3d's) are scaled by PROB_GAIN, so the depth softmax is
    decisive rather than near-uniform; ASFF's output norms' scales and
    shifts by ASFF_GAIN.  Made on the CPU from a torch.Generator, so a seed gives
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
        if ".expand.bn." in key and leaf in ("weight", "bias"):
            val = val * ASFF_GAIN
        out[key] = val.to(ref.dtype)
    return out
