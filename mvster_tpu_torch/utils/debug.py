"""Debug dumps: the vis_ETA / vis_mono / save_jpg equivalents (counterpart of mvster_tpu.utils.debug).

The reference writes its .npy/.jpg dumps from inside the model forward; as
in the JAX package, the model returns its intermediates instead
(MVS4Net.forward(return_debug=True)) and these helpers write them after
the step.  `attention_maps` recomputes the vis_ETA per-view epipolar
attention volumes from a stage's features: on a card its warp is the
warp-only gather kernel K2 (kernels/warp_vjp.warp_gather, as the JAX
package's is its Pallas warp-only kernel), on the CPU the plain gather.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mvster_tpu_torch.core.geometry import plane_sweep_coords
from mvster_tpu_torch.kernels.cost_volume import correlate


class DebugDumper:
    """Writes numpy arrays and colour-mapped depths under `outdir`; does
    nothing when not `enabled`."""

    def __init__(self, outdir: str, enabled: bool = True):
        self.outdir = outdir
        self.enabled = enabled
        if enabled:
            os.makedirs(outdir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.outdir, name)

    def save_npy(self, name: str, array) -> None:
        if self.enabled:
            if isinstance(array, torch.Tensor):
                array = array.detach().cpu().numpy()
            np.save(self._path(name), np.asarray(array))

    def save_depth_jpg(self, name: str, depth) -> None:
        """Jet-colourmapped depth (the --save_jpg view)."""
        if not self.enabled:
            return
        import cv2

        if isinstance(depth, torch.Tensor):
            depth = depth.detach().cpu().numpy()
        depth = np.asarray(depth)
        valid = depth > 0
        mi = depth[valid].min() if valid.any() else 0.0
        ma = depth.max()
        norm = np.clip((depth - mi) / (ma - mi + 1e-8), 0, 1)
        cv2.imwrite(self._path(name),
                    cv2.applyColorMap((255 * norm).astype(np.uint8), cv2.COLORMAP_JET))

    def dump_stage_outputs(self, outputs: dict, prefix: str = "") -> None:
        """Each stage's attention volume and hypotheses (.npy), its depth
        and, where there is one, its mono depth (.jpg) of the first item."""
        if not self.enabled:
            return
        for key, stage in outputs.items():
            if not key.startswith("stage") or not isinstance(stage, dict):
                continue
            self.save_npy(f"{prefix}{key}_attn_weight.npy", stage["attn_weight"])
            self.save_npy(f"{prefix}{key}_hypo_depth.npy", stage["hypo_depth"])
            self.save_depth_jpg(f"{prefix}{key}_depth.jpg", stage["depth"][0])
            if "mono_depth" in stage:
                self.save_depth_jpg(f"{prefix}{key}_mono.jpg", stage["mono_depth"][0])


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
