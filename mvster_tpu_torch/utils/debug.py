"""Debug dumps: the vis_ETA attention volumes (counterpart of mvster_tpu.utils.debug.attention_maps).

The reference writes its .npy/.jpg dumps from inside the model forward; as
in the JAX package, the model returns its intermediates instead
(MVS4Net.forward(return_debug=True)) and tools/test.py writes them after
the step.  `attention_maps` recomputes the vis_ETA per-view epipolar
attention volumes from a stage's features: on a card its warp is the
warp-only gather kernel K2 (kernels/warp_vjp.warp_gather, as the JAX
package's is its Pallas warp-only kernel), on the CPU the plain gather.
"""

from __future__ import annotations

import torch

from mvster_tpu_torch.core.geometry import plane_sweep_coords
from mvster_tpu_torch.kernels.cost_volume import correlate


def attention_maps(ref_feat, src_feats, ref_proj, src_projs, depth_hypo,
                   group_cor=True, group_dim=8, attn_temp=2.0):
    """Per-source-view epipolar attention volumes (the vis_ETA dumps).

    ref_feat (B, H, W, C), src_feats V-1 tensors (B, H, W, C), ref_proj
    (B, 4, 4), src_projs V-1 tensors (B, 4, 4), depth_hypo (B, D, H, W).
    Returns (V-1, B, D, H, W): per view, the softmax over depth of the
    channel-summed correlation.  As the JAX function computes it, the
    softmax takes no temperature: `attn_temp` is accepted and unused.
    """
    from mvster_tpu_torch.kernels.warp_vjp import warp_gather

    maps = []
    for feat, proj in zip(src_feats, src_projs):
        x, y = plane_sweep_coords(proj, ref_proj, depth_hypo)
        warped = warp_gather(feat.contiguous(), x.contiguous(), y.contiguous())
        cor = correlate(warped, ref_feat, group_cor, group_dim)
        maps.append(torch.softmax(torch.sum(cor, dim=-1), dim=1))
    return torch.stack(maps)
