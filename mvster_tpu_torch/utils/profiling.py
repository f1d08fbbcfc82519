"""Named spans in torch.profiler traces (counterpart of mvster_tpu.utils.profiling).

`span(name)` marks a phase of the program (an input copy, a forward, a
wait) as a `record_function` range in whatever torch.profiler session is
recording: the benchmark's traced runs, `tools.train --mode profile`, or
an operator's own.  The range lands in the same trace as the kernels and
the CUDA runtime calls, on the same clock, so a trace reader can put each
kernel, launch, synchronisation and idle gap down to the phase it fell in.

The profiler session is the switch.  With none recording, `span` returns
one shared no-op context: no range is entered and nothing is allocated,
so a span costs one check of the profiler's state.

Spans of the port, each entered once a unit of work:
  infer.h2d, infer.forward, infer.wait    tools/test.infer_views, a chunk
  mvs.fpn; mvs.cost_volume, mvs.reg       models/mvs4net, a forward; a stage
  train.batch_wait, train.h2d             train/loop, a step (h2d also in
                                          evaluate and tools/train._profile)
  train.step, train.optimizer             dist/train_step.make_train_step
  train.forward, train.loss,              dist/train_step, a microbatch
  train.backward
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function` range named `name` while a profiler records; the
    shared no-op context otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
