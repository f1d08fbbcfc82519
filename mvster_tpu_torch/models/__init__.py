"""The cascade model."""

from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig

__all__ = ["MVS4Net", "MVS4NetConfig"]
