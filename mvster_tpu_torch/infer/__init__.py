"""Fusion of depth maps into point clouds, and PLY IO (counterpart of mvster_tpu.infer)."""

from mvster_tpu_torch.infer.fusion import fuse_scene, geometric_filter
from mvster_tpu_torch.infer.ply import read_ply, write_ply

__all__ = ["fuse_scene", "geometric_filter", "read_ply", "write_ply"]
