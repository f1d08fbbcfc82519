"""MVS4NetConfig: the cascade's configuration (counterpart of mvster_tpu.models.mvs4net.MVS4NetConfig).

Same fields, defaults and `dtu_default` as the JAX dataclass, so one
configuration names the same model in both packages
(tests/test_torch_model.py asserts the equality).  The port runs every
configuration the JAX package runs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class MVS4NetConfig:
    arch_mode: str = "fpn"  # fpn | convnext | convnext4
    reg_net: str = "reg2d"  # reg2d | reg3d
    num_stage: int = 4
    fpn_base_channel: int = 8
    reg_channel: int = 8
    stage_splits: Sequence[int] = (8, 8, 4, 4)
    depth_interals_ratio: Sequence[float] = (0.5, 0.5, 0.5, 1.0)
    group_cor: bool = False
    group_cor_dim: Sequence[int] = (8, 8, 8, 8)
    inverse_depth: bool = False
    agg_type: str = "ConvBnReLU3D"
    dcn: bool = False
    pos_enc: int = 0  # 0 none | 1 sine | 2 learned
    mono: bool = False
    asff: bool = False
    attn_temp: float = 2.0
    attn_fuse_d: bool = True
    reg3d_down_size: Sequence[int] = (3, 3, 2, 2)
    compute_dtype: str = "float32"
    # The next four select TPU formulations in the JAX package: the Pallas
    # or XLA warp, the depth-folded reg2d and the composed FPN tail, all
    # numerically equal to the standard formulation (the JAX package's
    # tests/test_reg_folded.py and tests/test_fpn_compose.py).  The port
    # runs the standard formulation that the reference checkpoint defines
    # and the CUDA kernel, so they are accepted and have no effect here.
    warp_impl: str = "pallas"
    reg2d_fold: bool = True
    fpn_compose: bool = True
    fpn_compose_mode: str = "hconv"
    # training-only measurement hook of the JAX package: detach() at the
    # named boundaries "fpn", "warp", "cost_volume", "logits", "mono"
    # (models/mvs4net.py); the forward is unchanged
    sg_cuts: Sequence[str] = ()

    @classmethod
    def dtu_default(cls, **overrides) -> "MVS4NetConfig":
        """The published DTU training config (scripts/train_dtu.sh:20-24)."""
        base = dict(
            group_cor=True,
            group_cor_dim=(8, 8, 4, 4),
            inverse_depth=True,
            mono=True,
            attn_temp=2.0,
        )
        base.update(overrides)
        return cls(**base)

