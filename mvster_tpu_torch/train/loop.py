"""Epoch-level training orchestration (counterpart of mvster_tpu.train.loop).

`train_epoch` runs the train step over one epoch of the loader and logs
every summary_freq-th step; `evaluate` runs the eval step over a loader,
padding a trailing partial batch with zero-mask duplicates
(`pad_eval_batch`) so every batch has one shape while the metrics stay
those of the unpadded data.  Data parallel, every rank runs both over its
shard (the loader pads the shards to one length, so every rank takes the
same steps and joins the same collectives), the step's scalars are
already the global batch's, and only rank 0 prints (`print_fn`) and logs.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from mvster_tpu_torch.train.metrics import DictAverageMeter, tree_to_float


def device_batch(batch, device):
    """A numpy batch dict (nested) -> float32 tensors on `device`; lists and
    strings (file names) are dropped."""
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)

    return {k: move(v) for k, v in batch.items() if not isinstance(v, (list, str))}


def train_epoch(train_step: Callable, loader, epoch: int, device, logger=None,
                summary_freq: int = 100, steps_per_epoch: int | None = None,
                log_prefix: str = "train", print_fn: Callable = print) -> int:
    """One epoch of train steps; returns the number of steps taken."""
    loader.set_epoch(epoch)
    n_batches = steps_per_epoch or len(loader)
    steps = 0
    for batch_idx, batch in enumerate(loader):
        t0 = time.time()
        global_step = n_batches * epoch + batch_idx
        scalars, images = train_step(device_batch(batch, device))
        steps += 1
        if global_step % summary_freq == 0:
            scalars = tree_to_float(scalars)
            if logger is not None:
                logger.scalars(log_prefix, scalars, global_step)
                logger.images(log_prefix, {k: v.cpu().numpy() for k, v in images.items()},
                              global_step)
            print_fn(
                f"Epoch {epoch}, Iter {batch_idx}/{n_batches}, "
                f"loss = {scalars['loss']:.3f}, "
                f"c_loss = {scalars.get('s0_c_loss', 0):.3f}/"
                f"{scalars.get('s3_c_loss', 0):.3f}, "
                f"abs_err = {scalars.get('abs_depth_error', 0):.3f}, "
                f"time = {time.time() - t0:.3f}"
            )
    return steps


def pad_eval_batch(batch, target: int):
    """Pad a trailing partial batch to `target` samples with duplicates of
    its last sample whose GT masks are zero: every masked-mean loss and
    depth metric of the eval step ignores them exactly."""
    n = next(v.shape[0] for v in batch.values() if isinstance(v, np.ndarray))
    if n == target:
        return batch

    def pad(x):
        if isinstance(x, dict):
            return {k: pad(v) for k, v in x.items()}
        if isinstance(x, np.ndarray) and x.ndim >= 1 and x.shape[0] == n:
            return np.concatenate([x, np.repeat(x[-1:], target - n, axis=0)], axis=0)
        return x

    padded = {k: pad(v) for k, v in batch.items()}
    padded["mask"] = {
        k: np.concatenate([np.asarray(v[:n]),
                           np.zeros((target - n, *v.shape[1:]), v.dtype)])
        for k, v in batch["mask"].items()
    }
    return padded


def evaluate(eval_step: Callable, loader, device, logger=None, global_step: int = 0,
             log_prefix: str = "fulltest", print_fn: Callable = print) -> dict:
    meter = DictAverageMeter()
    for batch in loader:
        batch = pad_eval_batch(batch, loader.batch_size)
        meter.update(tree_to_float(eval_step(device_batch(batch, device))))
    means = meter.mean()
    if logger is not None and means:
        logger.scalars(log_prefix, means, global_step)
    if means:
        print_fn(f"avg_test_scalars: {means}")
    return means
