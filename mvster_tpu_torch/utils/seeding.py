"""Determinism helper (counterpart of mvster_tpu.utils.seeding).

Seeds Python's, numpy's and torch's generators.  The data augmentations
take explicit per-sample seeds (data/common.sample_rng), and the model's
initial weights come from tools/weights.init_state_dict with their own
generator, so neither depends on this global state.  Data-parallel ranks
all take the same seed, as the JAX package draws its weights from one
PRNGKey: every rank starts from the same weights, and DDP's broadcast of
rank 0's at construction changes nothing.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
