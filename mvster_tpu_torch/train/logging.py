"""Metric and image logging: JSONL always, TensorBoard when it imports (counterpart of mvster_tpu.train.logging).

Scalars stream to <logdir>/metrics.jsonl, one record per call, so a
headless run keeps a machine-readable trace.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricLogger:
    def __init__(self, logdir: str, enable_tb: bool = True, is_main: bool = True):
        self.logdir = logdir
        self.is_main = is_main
        self.tb = None
        self.jsonl = None
        if not is_main:
            return
        os.makedirs(logdir, exist_ok=True)
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(logdir)
            except Exception:
                self.tb = None

    def scalars(self, mode: str, scalar_dict: dict, step: int):
        if not self.is_main:
            return
        record = {"mode": mode, "step": step, "time": time.time()}
        for key, value in scalar_dict.items():
            value = float(value)
            record[key] = value
            if self.tb is not None:
                self.tb.add_scalar(f"{mode}/{key}", value, step)
        self.jsonl.write(json.dumps(record) + "\n")
        self.jsonl.flush()

    def images(self, mode: str, image_dict: dict, step: int):
        """Log (B, H, W[, C]) arrays as normalised grayscale or colour images."""
        if not self.is_main or self.tb is None:
            return
        for key, img in image_dict.items():
            img = np.asarray(img)[0]  # first batch element
            if img.ndim == 2:
                img = img[None]  # CHW gray
            elif img.ndim == 3 and img.shape[-1] in (1, 3):
                img = img.transpose(2, 0, 1)
            lo, hi = float(img.min()), float(img.max())
            img = (img - lo) / (hi - lo + 1e-8)
            self.tb.add_image(f"{mode}/{key}", img.astype(np.float32), step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.jsonl is not None:
            self.jsonl.close()
