"""Depth positional encodings of the cost volume (counterpart of mvster_tpu.nn.posenc).

Both add to the (B, D, H, W, C) volume that the cost volume emits, before
the regulariser.  The learned embedding's reference key is
`pos_enc_func.{s}`, in torch layout (C, D); MVS4Net keeps the stages'
embeddings in that ParameterList.
"""

from __future__ import annotations

import math

import torch


def pos_enc_sine(x: torch.Tensor, depth: torch.Tensor,
                 temperature: float = 1000.0) -> torch.Tensor:
    """x (B, D, H, W, C) plus [sin | cos] of (depth / temperature) * i * pi
    for i < C // 2, with no gradient through the encoding; depth (B, D, H, W)."""
    freqs = torch.arange(x.shape[-1] // 2, dtype=x.dtype, device=x.device) * math.pi
    angles = (depth / temperature)[..., None] * freqs
    return x + torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1).detach()


def pos_enc_learned(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """x (B, D, H, W, C) plus the learned embed (C, D) of each depth bin."""
    return x + embed.t()[None, :, None, None, :]
