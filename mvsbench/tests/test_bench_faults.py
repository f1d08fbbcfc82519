"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(run.measure: set-up, the window, the check against the cell's own limits)
on the CPU at a small size, with one fault planted in the program: an
answer altered where it is produced (serving), a step that leaves the
state unchanged, half of each batch left out with the mean taken over the
rest, a stage's depth altered where it is produced, and a fault that
starts only once the warm-up is over (training).  The same run without a
fault comes out correct.
"""

import contextlib

import pytest
import torch

from mvsbench.cells import Cell
from mvsbench.run import measure

SEED = 2**31 + 101


def small(name, **extra):
    cell = Cell(name)
    cell.traffic.update(height=64, width=128, pool=4, warmup=3, check_views=2,
                        trace_after=1, trace_count=2)
    if cell.driver != "serve":
        cell.traffic.update(views=3, batch=1)
    cell.traffic.update(extra)
    return cell


def run(cell, seconds=1.5):
    torch.set_num_threads(4)
    return measure(cell, SEED, seconds, False, torch.device("cpu"))


@contextlib.contextmanager
def patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


@pytest.mark.parametrize("cell", ["dtu-test-serve", "dtu-mid-train", "blendedmvs-train"])
def test_a_sound_run_is_correct(cell):
    line = run(small(cell))
    assert line["correct"], line["checks"]


def test_serving_an_altered_answer():
    import mvster_tpu_torch.tools.test as tool

    def make(drain):
        def altered(pending):
            for sample, view in drain(pending):
                view["depth"] = view["depth"] * 1.01
                yield sample, view
        return altered

    with patched(tool, "_drain", make):
        line = run(small("dtu-test-serve"))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["dtu-mid-train", "blendedmvs-train"])
def test_a_step_that_leaves_the_state_unchanged(cell):
    with patched(torch.optim.Adam, "step", lambda step: lambda self, *a, **k: None):
        line = run(small(cell))
    assert not line["correct"], line["checks"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["dtu-mid-train", "blendedmvs-train"])
def test_half_of_each_batch_left_out(cell):
    import mvster_tpu_torch.train.loop as loop

    def make(device_batch):
        def half(batch, device):
            def cut(x):
                return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) else x[:len(x) // 2]
            return device_batch(cut(batch), device)
        return half

    with patched(loop, "device_batch", make):
        line = run(small(cell, batch=2, pool=8))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["dtu-mid-train", "blendedmvs-train"])
def test_a_stage_depth_altered_where_it_is_produced(cell):
    from mvster_tpu_torch.models.mvs4net import MVS4Net

    def make(forward):
        def altered(self, *args, **kwargs):
            out = forward(self, *args, **kwargs)
            out["stage2"]["depth"] = out["stage2"]["depth"] * 1.01
            return out
        return altered

    with patched(MVS4Net, "forward", make):
        line = run(small(cell))
    assert not line["correct"], line["checks"]
    assert line["checks"]["depth_off"]["value"] > 1e-3


@pytest.mark.parametrize("cell", ["dtu-mid-train", "blendedmvs-train"])
def test_a_fault_that_starts_after_the_warm_up(cell):
    """Adam's steps do nothing once the warm-up's steps are taken: only a
    check of the window's own steps sees it."""
    small_cell = small(cell)
    warmup = small_cell.traffic["warmup"]

    def make(step):
        calls = []

        def late(self, *a, **k):
            calls.append(1)
            return step(self, *a, **k) if len(calls) <= warmup else None
        return late

    with patched(torch.optim.Adam, "step", make):
        line = run(small_cell)
    assert not line["correct"], line["checks"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
