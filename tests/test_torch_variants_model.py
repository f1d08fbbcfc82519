"""Every model variant of the JAX package through the port's MVS4Net, against the JAX package.

Eval forward: each variant of _torch_parity.VARIANTS but bfloat16
(tests/test_torch_bf16.py) on the textured-plane scene at 64x64 with 3
views, with random flax variables exported by state_dict_from_jax and
loaded strictly, by the stage comparator (assert_stage_close, attention
at atol 2e-3), against the JAX package's default formulation (its folded
Reg2d and composed FPN tail are eval-time rewrites of the same function);
and num_stage 3, the cascade cut after stage 3.  The ConvNeXt layer
scales are small normals here, as random_state_dict draws them
(tests/test_torch_variants.py holds the pyramids at larger ones): larger
ones make the cost volume, and the logits after it, so large that float32
rounding alone moves near-tied attention by more than the comparator's
atol, in either package's formulations.

Weights: for every variant the port's exporter (tools/convert.py) gives a
state dict that loads strictly into the port's model, and the JAX
package's importer (mvster_tpu.tools.convert_torch_ckpt.convert_state_dict)
maps it back onto the same flax tree, leaf for leaf.  DCN's offset and
modulation convs (`feature.dcn{n}.2.p_conv|m_conv`) are left out of that
second check: the reference's DeformConvPack has no such keys, so that
importer does not know them.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_parity import (
    VARIANTS,
    assert_stage_close,
    jax_variables,
    run_jax_model,
    t,
    to_numpy_tree,
)
from helpers import plane_scene_sample
from mvster_tpu.models import MVS4NetConfig as JaxConfig
from mvster_tpu_torch.config import MVS4NetConfig
from mvster_tpu_torch.models.mvs4net import MVS4Net
from mvster_tpu_torch.tools.convert import export_state_dict
from mvster_tpu_torch.tools.weights import state_dict_from_jax

FORWARD = {k: v for k, v in VARIANTS.items() if k != "bf16"}
FORWARD["num_stage3"] = dict(num_stage=3)


@functools.lru_cache(maxsize=None)
def _variables(name):
    overrides = {**VARIANTS, **FORWARD}[name]
    return jax_variables(JaxConfig.dtu_default(mono=False, **overrides),
                         plane_scene_sample(0), seed=0)


@pytest.mark.parametrize("name", list(FORWARD))
def test_variant_eval_forward_matches_jax(name):
    overrides = FORWARD[name]
    sample = plane_scene_sample(0)
    variables = _variables(name)
    want = run_jax_model(JaxConfig.dtu_default(mono=False, **overrides), variables, sample)
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False, **overrides)).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = to_numpy_tree(model(
            t(sample["imgs"]), {k: t(v) for k, v in sample["proj_matrices"].items()},
            t(sample["depth_values"])))
    num_stage = overrides.get("num_stage", 4)
    assert_stage_close(want, got, num_stage=num_stage)
    assert got.keys() == want.keys()
    for s in range(1, num_stage + 1):
        assert got[f"stage{s}"]["warp_fallbacks"] == 0
    size = 64 // 2 ** (4 - num_stage)
    assert got["depth"].shape == (1, size, size)
    assert got["photometric_confidence"].shape == (1, 64, 64)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_weights_round_trip(name):
    from mvster_tpu.tools.convert_torch_ckpt import convert_state_dict

    variables = _variables(name)
    exported = export_state_dict(variables)
    model = MVS4Net(MVS4NetConfig.dtu_default(mono=False, **VARIANTS[name]))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
                          strict=True)
    unknown = (".p_conv.", ".m_conv.")
    back = convert_state_dict({k: v for k, v in exported.items()
                               if not any(u in k for u in unknown)})
    want = {p: v for c in ("params", "batch_stats") for p, v in _leaves(variables[c], (c,))
            if not {"p_conv", "m_conv"} & set(p)}
    got = dict(leaf for c in ("params", "batch_stats") for leaf in _leaves(back.get(c, {}), (c,)))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))
