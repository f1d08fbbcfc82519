"""The port's spans (utils/profiling.py), on the CPU.

Without a profiler `span` returns one shared no-op context, and a pass
of infer_views enters no `record_function`.  Under torch.profiler each
served view shows infer.h2d, infer.forward and infer.wait, with one
mvs.fpn and a mvs.cost_volume and a mvs.reg a stage inside infer.forward,
and with DCN heads a mvs.dcn a head inside mvs.fpn;
each step of train_epoch shows train.batch_wait, train.h2d and
train.step, with train.forward, train.loss, train.backward and
train.optimizer inside train.step.  The tiny model of
tests/test_torch_infer_views.py, at 64x64.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_parity import plane_batch
from mvster_tpu_torch.utils import profiling
from mvster_tpu_torch.utils.profiling import span

CFG = dict(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
           fpn_base_channel=4, reg_channel=4, attn_temp=2.0)
N_VIEWS = 2
N_STEPS = 2


def _model(**overrides):
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.weights import random_state_dict

    model = MVS4Net(MVS4NetConfig(**CFG, **overrides))
    model.load_state_dict(random_state_dict(model, seed=0), strict=True)
    return model


def _samples():
    from helpers import plane_scene_sample

    out = []
    for seed in range(N_VIEWS):
        s = plane_scene_sample(seed)
        out.append({"imgs": s["imgs"][0], "depth_values": s["depth_values"][0],
                    "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()}})
    return out


def _spans(prof):
    """{name: [(start, end)]} of the ranges the port's spans opened."""
    out = {}
    for e in prof.events():
        if e.name.startswith(("infer.", "mvs.", "train.")):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def _inside(spans, outer):
    """For each span of `outer`, how many of `spans` lie inside it."""
    return [sum(a <= s and e <= b for s, e in spans) for a, b in outer]


def test_span_is_a_shared_no_op_and_infer_views_enters_no_range_without_a_profiler(
        monkeypatch):
    from mvster_tpu_torch.tools.test import infer_views

    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not torch._C._autograd._profiler_enabled()
    assert span("infer.h2d") is span("train.step") is profiling._OFF
    views = list(infer_views(_model().eval(), _samples()))
    assert len(views) == N_VIEWS and entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("infer.h2d"):
            pass
    assert entered == ["infer.h2d"]


def test_infer_views_spans_under_the_profiler():
    from mvster_tpu_torch.tools.test import infer_views

    model, samples = _model().eval(), _samples()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        views = list(infer_views(model, samples))
    assert len(views) == N_VIEWS
    got = _spans(prof)
    for name in ("infer.h2d", "infer.forward", "infer.wait"):
        assert len(got.get(name, [])) == N_VIEWS, (name, got.keys())
    forwards = got["infer.forward"]
    assert _inside(got["mvs.fpn"], forwards) == [1] * N_VIEWS
    assert _inside(got["mvs.cost_volume"], forwards) == [4] * N_VIEWS
    assert _inside(got["mvs.reg"], forwards) == [4] * N_VIEWS
    # the copy in comes before the forward, the wait after it
    for (h, _), (f0, f1), (w, _) in zip(got["infer.h2d"], forwards, got["infer.wait"]):
        assert h < f0 and f1 <= w


@pytest.mark.parametrize("dcn", [True, False])
def test_dcn_heads_each_a_span_inside_the_fpn(dcn):
    from mvster_tpu_torch.tools.test import infer_views

    model, samples = _model(dcn=dcn).eval(), _samples()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        views = list(infer_views(model, samples))
    assert len(views) == N_VIEWS
    got = _spans(prof)
    assert len(got["mvs.fpn"]) == N_VIEWS
    heads = got.get("mvs.dcn", [])
    assert _inside(heads, got["mvs.fpn"]) == [4 if dcn else 0] * N_VIEWS
    assert len(heads) == (4 * N_VIEWS if dcn else 0)


class _Loader:
    """Two numpy batches, an epoch of MVSLoader's interface."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("loss", ["mvs4net_loss", "blend_loss"])
def test_train_epoch_spans_under_the_profiler(loss):
    from mvster_tpu_torch.dist.train_step import make_train_step
    from mvster_tpu_torch.models import losses
    from mvster_tpu_torch.train.loop import train_epoch

    model = _model(mono=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: 1.0)
    step = make_train_step(model, optimizer, getattr(losses, loss),
                           dict(inverse_depth=True, ot_iter=2, mono=True),
                           scheduler=scheduler)
    loader = _Loader([plane_batch(1) for _ in range(N_STEPS)])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        taken = train_epoch(step, loader, 0, torch.device("cpu"), print_fn=lambda *a: None)
    assert taken == N_STEPS
    got = _spans(prof)
    # one wait a batch, and the last next() that finds the loader's end
    assert len(got["train.batch_wait"]) == N_STEPS + 1
    assert len(got["train.h2d"]) == len(got["train.step"]) == N_STEPS
    steps = got["train.step"]
    for name in ("train.forward", "train.loss", "train.backward", "train.optimizer"):
        assert _inside(got[name], steps) == [1] * N_STEPS, name
    assert _inside(got["mvs.cost_volume"], got["train.forward"]) == [4] * N_STEPS
    for (w, _), (h0, h1), (s0, _) in zip(got["train.batch_wait"], got["train.h2d"], steps):
        assert w < h0 and h1 <= s0
    assert all(np.isfinite(p.detach().numpy()).all() for p in model.parameters())
