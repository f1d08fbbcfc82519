"""The yardstick's arithmetic at DTU-mid's shapes against the bounds that
the port's kernel table (PERF.md) states."""

import pytest

from mvsbench import work
from mvsbench.cells import Cell, load_metric
from mvsbench.reference import model
from mvsbench.reference.model import Config


def shapes():
    return work.stage_shapes(512, 640, Config())


def test_stage_shapes():
    assert shapes() == [(64, 80, 64, 8, 8), (128, 160, 32, 8, 8), (256, 320, 16, 4, 4),
                        (512, 640, 8, 4, 4)]


@pytest.mark.parametrize("kernel, batch, views, ms", [
    ("k1", 1, 5, 0.0413),   # four source views a launch, batch 1
    ("k2", 2, 2, 0.0769),   # one source view a launch, batch 2
    ("k3", 2, 2, 0.0769),
    ("k4", 2, 5, 0.1302),   # 10 iterations, batch 2
    ("k5", 2, 5, 0.2713),
])
def test_least_times_at_dtu_mid(kernel, batch, views, ms):
    assert work.least_seconds(kernel, shapes(), batch, views) * 1e3 == pytest.approx(ms, rel=2e-3)


def test_ot_work_counts():
    (k4_pipe, _, _), (k5_pipe, _, _) = work.ot_work(2 * 64 * 80, 8)
    assert k4_pipe > 0 and k5_pipe > 2 * k4_pipe


def test_reference_flops():
    serve = work.reference_flops(model, Config(), 128, 192, 5, 1, train=False)
    train = work.reference_flops(model, Config(), 128, 192, 5, 1, train=True)
    assert serve > 0 and 2 * serve < train < 5 * serve


@pytest.mark.parametrize("cell, kernel, seconds", [
    ("dtu-test-serve", "k1", 0.0001208811367164179),
    ("dtu-mid-train", "k2", 0.0003075301253731343),
    ("dtu-mid-train", "k3", 0.0003075301253731343),
    ("dtu-mid-train", "k4", 0.00013006939701492537),
    ("dtu-mid-train", "k5", 0.00027093511641791045),
    ("blendedmvs-train", "k2", 0.000622748503880597),
    ("blendedmvs-train", "k3", 0.000622748503880597),
    ("blendedmvs-train", "k4", 0.00017559368597014927),
    ("blendedmvs-train", "k5", 0.0003657624071641791),
])
def test_least_times_of_the_cells(cell, kernel, seconds):
    """`least_s` of mvsbench/metrics/<kernel>_roofline.py at each cell's
    shapes: the values the drivers' own arithmetic gave before the lookup
    by name, to the last digit."""
    assert load_metric(f"{kernel}_roofline").least_s(Cell(cell)) == seconds
