"""Checkpoints in the reference's format (counterpart of mvster_tpu.train.checkpoint).

Each save writes {"epoch", "model", "optimizer"} with torch.save, as the
reference's training script does, to <dir>/model_<epoch>.ckpt (six digits),
and keeps the newest `keep`; tools.weights.load_reference_ckpt reads the
model weights back, and `latest` finds the file to resume from.  A model
wrapped in DistributedDataParallel is saved and restored as its module, so
the keys carry no `module.` prefix; under a process group rank 0 writes
and every rank waits for it at a barrier, and every rank restores.
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

from mvster_tpu_torch.dist.mesh import is_main, world_size


class CheckpointManager:
    PATTERN = re.compile(r"model_(\d+)\.ckpt$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"model_{epoch:06d}.ckpt")

    def all_epochs(self) -> list[int]:
        found = (self.PATTERN.search(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer) -> str:
        path = self.path(epoch)
        if is_main():
            tmp = path + ".tmp"
            torch.save({"epoch": epoch, "model": getattr(model, "module", model).state_dict(),
                        "optimizer": optimizer.state_dict()}, tmp)
            os.replace(tmp, path)
            for old in self.all_epochs()[: -self.keep]:
                os.remove(self.path(old))
        if world_size() > 1:
            dist.barrier()
        return path

    def latest(self) -> str | None:
        epochs = self.all_epochs()
        return self.path(epochs[-1]) if epochs else None

    def restore(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> int | None:
        """Load the newest checkpoint into model and optimizer (read on the
        CPU, copied to the parameters' device); returns its epoch, or None
        when there is none."""
        path = self.latest()
        if path is None:
            return None
        state = torch.load(path, map_location="cpu", weights_only=True)
        getattr(model, "module", model).load_state_dict(state["model"], strict=True)
        optimizer.load_state_dict(state["optimizer"])
        return int(state["epoch"])
