"""flax variable tree -> reference MVSTER state dict, in numpy (the port's own copy).

Counterpart of mvster_tpu.tools.convert_torch_ckpt.export_state_dict, kept
here so the port imports nothing of the JAX package.  It inverts the JAX
package's channels-last layouts: conv HWIO / DHWIO -> OIHW / OIDHW, the
pre-flipped transposed-conv kernel -> IODHW, dense (in, out) -> (out, in),
and routes each flax path onto the reference key grammar:

  feature.conv{0..3}.{i}.conv.weight|bn.*      encoder blocks
  feature.conv0_{0|1}.conv.weight|bn.*         ConvNeXt stems
  feature.conv{1..3}.<layer>.*|gamma           ConvNeXt blocks (dwconv,
                                               sconv, norm, pwconv1|2)
  feature.inner{1..3}.weight|bias              lateral 1x1 convs
  feature.out{1..4}.weight                     output heads
  feature.dcn{1..4}.0.* / .2.weight            DCN norm / tap kernel
  feature.dcn{1..4}.2.p_conv|m_conv.*          DCN offset and modulation
                                               convs (the port's names)
  reg.{s}.conv{n}.conv.weight|bn.*             U-Net conv blocks
  reg.{s}.conv{n}.linear_agg.{0|2}.*           CAM/DCAM attention MLPs
  reg.{s}.conv{n}.pixel_conv|spatial_conv.*    PAM/PDAM gates
  reg.{s}.conv{7|9|11}.0.weight + .1.*         deconv + BN sequentials
  reg.{s}.prob.weight|bias                     logit head
  mono_depth_decoder.convblocks.{i}.*          mono decoder conv blocks
  mono_depth_decoder.conv3x3.{i}.*             mono disparity heads
  asff.{l}.<name>.conv.weight|bn.* / weight_levels
  pos_enc_func.{s}                             learned depth embedding (C, D)

Works on any tree of that shape: flax variables, or gradients of the
"params" collection (tests export the JAX package's gradients through it).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np


def _inv_conv2d(w):  # (kh, kw, I, O) -> (O, I, kh, kw)
    return np.transpose(w, (3, 2, 0, 1))


def _inv_conv3d(w):  # (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
    return np.transpose(w, (4, 3, 0, 1, 2))


def _inv_deconv3d(w):  # flipped (kd, kh, kw, I, O) -> (I, O, kd, kh, kw)
    return np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)).copy()


def _linear(w):  # (I, O) -> (O, I)
    return np.transpose(w, (1, 0))


def _inv_taps(w):  # DCN (n, C, O), n = ki * k + kj -> (O, C, k, k)
    k = int(round(w.shape[0] ** 0.5))
    return np.transpose(w, (2, 1, 0)).reshape(w.shape[2], w.shape[1], k, k).copy()


_INV_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(path_leaf, value, inv):
    """(torch leaf name, value) of a kernel/bias leaf."""
    if path_leaf == "kernel":
        return "weight", inv(value)
    return "bias", value


def export_state_dict(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """flax {"params", "batch_stats"} -> torch-layout state dict (numpy).

    BatchNorm num_batches_tracked leaves are added (zeros) for every norm
    that has running statistics, so load_state_dict(strict=True) accepts it.
    """
    out: dict[str, np.ndarray] = {}
    bn_seen: set[str] = set()

    def put_norm(tkey_prefix, leaf, value):
        out[f"{tkey_prefix}.{_INV_BN[leaf]}"] = value
        bn_seen.add(tkey_prefix)

    # the ConvNeXt pyramids name their blocks conv1..conv3 and their stems
    # conv0_0 / conv0_1, where FPN4's encoder blocks are conv{n}_{i}
    convnext = "conv1" in variables.get("params", {}).get("feature", {})
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            head = path[0]
            if head == "feature":
                name = path[1]
                m = re.fullmatch(r"conv(\d)_(\d)", name)
                if m:
                    tprefix = (f"feature.{name}" if convnext
                               else f"feature.conv{m.group(1)}.{m.group(2)}")
                    if path[2] == "conv":
                        leaf, val = _leaf(path[3], value, _inv_conv2d)
                        out[f"{tprefix}.conv.{leaf}"] = val
                    else:  # bn / gn
                        put_norm(f"{tprefix}.{path[2]}", path[3], value)
                    continue
                if re.fullmatch(r"(inner|out)\d", name):
                    leaf, val = _leaf(path[2], value, _inv_conv2d)
                    out[f"feature.{name}.{leaf}"] = val
                    continue
                if re.fullmatch(r"conv\d", name):  # a ConvNeXt block
                    layer = path[2]
                    if layer == "gamma":
                        out[f"feature.{name}.gamma"] = value
                    elif layer == "norm":  # LayerNorm: scale, bias
                        out[f"feature.{name}.norm.{_INV_BN[path[3]]}"] = value
                    else:  # dwconv, sconv, pwconv1, pwconv2
                        inv = _linear if layer.startswith("pwconv") else _inv_conv2d
                        leaf, val = _leaf(path[3], value, inv)
                        out[f"feature.{name}.{layer}.{leaf}"] = val
                    continue
                if re.fullmatch(r"dcn\d", name):
                    if path[2] == "norm":
                        put_norm(f"feature.{name}.0", path[3], value)
                    elif path[3] == "kernel" and len(path) == 4:  # the tap kernel
                        out[f"feature.{name}.2.weight"] = _inv_taps(value)
                    else:  # p_conv, m_conv
                        leaf, val = _leaf(path[4], value, _inv_conv2d)
                        out[f"feature.{name}.2.{path[3]}.{leaf}"] = val
                    continue
                raise KeyError(f"unhandled feature path {path}")
            if head.startswith("reg_"):
                stage = head[4:]
                name = path[1]
                if name == "prob":
                    leaf, val = _leaf(path[2], value, _inv_conv3d)
                    out[f"reg.{stage}.prob.{leaf}"] = val
                elif path[2] == "kernel":  # deconv sequential
                    out[f"reg.{stage}.{name}.0.weight"] = _inv_deconv3d(value)
                elif path[2] == "bn" and name in ("conv7", "conv9", "conv11"):
                    put_norm(f"reg.{stage}.{name}.1", path[3], value)
                elif path[2] == "conv":
                    out[f"reg.{stage}.{name}.conv.weight"] = _inv_conv3d(value)
                elif path[2] == "bn":
                    put_norm(f"reg.{stage}.{name}.bn", path[3], value)
                elif path[2] == "linear_agg":
                    idx = {"fc0": "0", "fc1": "2"}[path[3]]
                    leaf, val = _leaf(path[4], value, _linear)
                    out[f"reg.{stage}.{name}.linear_agg.{idx}.{leaf}"] = val
                elif path[2] in ("pixel_conv", "spatial_conv"):
                    inv = _inv_conv2d if path[2] == "pixel_conv" else _inv_conv3d
                    leaf, val = _leaf(path[3], value, inv)
                    out[f"reg.{stage}.{name}.{path[2]}.{leaf}"] = val
                else:
                    raise KeyError(f"unhandled reg path {path}")
                continue
            if head == "mono_depth_decoder":
                name = path[1]
                m = re.fullmatch(r"convblock(\d)", name)
                if m:
                    tprefix = f"mono_depth_decoder.convblocks.{m.group(1)}"
                    if path[2] == "conv":
                        out[f"{tprefix}.conv.weight"] = _inv_conv2d(value)
                    else:
                        put_norm(f"{tprefix}.bn", path[3], value)
                    continue
                m = re.fullmatch(r"conv3x3_(\d)", name)
                if m:
                    leaf, val = _leaf(path[2], value, _inv_conv2d)
                    out[f"mono_depth_decoder.conv3x3.{m.group(1)}.{leaf}"] = val
                    continue
                raise KeyError(f"unhandled mono path {path}")
            if head.startswith("asff_"):
                level = head[5:]
                name = path[1]
                if name == "weight_levels":
                    leaf, val = _leaf(path[2], value, _inv_conv2d)
                    out[f"asff.{level}.weight_levels.{leaf}"] = val
                elif path[2] == "conv":
                    leaf, val = _leaf(path[3], value, _inv_conv2d)
                    out[f"asff.{level}.{name}.conv.{leaf}"] = val
                else:
                    put_norm(f"asff.{level}.{name}.{path[2]}", path[3], value)
                continue
            m = re.fullmatch(r"pos_enc_(\d)", head)
            if m and path[1:] == ("depth_embed",):  # (D, C) -> (C, D)
                out[f"pos_enc_func.{m.group(1)}"] = _linear(value).copy()
                continue
            raise KeyError(f"unhandled path {path}")

    for tprefix in bn_seen:
        if f"{tprefix}.running_mean" in out:
            out[f"{tprefix}.num_batches_tracked"] = np.zeros((), np.int64)
    return out
