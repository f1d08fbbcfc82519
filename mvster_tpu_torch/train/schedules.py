"""Learning-rate schedules as step -> factor functions (counterpart of mvster_tpu.train.schedules).

For torch.optim.lr_scheduler.LambdaLR, which sets lr = base_lr * f(step)
and is stepped once after each optimizer step, so the update of step k
uses f(k), as the optax schedule's count does: step 0 gives
base_lr * warmup_factor under the warmup-multistep schedule.

  MS        the reference's WarmupMultiStepLR: linear warmup over 500
            iterations from 1/3, then x gamma at each epoch milestone
  cos       cosine decay to 0 over all steps (optax.cosine_decay_schedule)
  onecycle  optax.cosine_onecycle_schedule: cosine from peak/25 up to peak
            over the first 30% of the steps, then down to peak/25/1e4
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence


def warmup_multistep_factor(milestones: Sequence[int], gamma: float = 0.5,
                            warmup_factor: float = 1.0 / 3,
                            warmup_iters: int = 500) -> Callable[[int], float]:
    ms = sorted(milestones)

    def factor(step: int) -> float:
        alpha = min(step, warmup_iters) / warmup_iters
        warm = warmup_factor * (1.0 - alpha) + alpha
        return warm * gamma ** bisect.bisect_right(ms, step)

    return factor


def cosine_factor(total_steps: int) -> Callable[[int], float]:
    def factor(step: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(step, total_steps) / total_steps))

    return factor


def onecycle_factor(total_steps: int, pct_start: float = 0.3,
                    div_factor: float = 25.0,
                    final_div_factor: float = 1e4) -> Callable[[int], float]:
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [1.0 / div_factor, 1.0, 1.0 / (div_factor * final_div_factor)]

    def factor(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[-1]

    return factor


def make_lr_factor(name: str, steps_per_epoch: int, epochs: int,
                   lrepochs: str = "6,8,9:2") -> Callable[[int], float]:
    """The factor for the reference CLI's spec: name "MS" | "cos" |
    "onecycle"; lrepochs "e1,e2,..:denom" (MS only)."""
    total_steps = steps_per_epoch * epochs
    if name == "MS":
        epoch_list, denom = lrepochs.split(":")
        milestones = [steps_per_epoch * int(e) for e in epoch_list.split(",")]
        return warmup_multistep_factor(milestones, gamma=1.0 / float(denom))
    if name == "cos":
        return cosine_factor(total_steps)
    if name == "onecycle":
        return onecycle_factor(total_steps)
    raise ValueError(f"unknown lr scheduler {name!r}")
