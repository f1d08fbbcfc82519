"""The control comes out not correct: the plain reference put in the
program's place and computed in the nearest precision below the
configuration's (TF32 operands for float32 with TF32 off), judged by each
cell's own comparison and limits, on the CPU at a small size.  The same
readings at the cells' own sizes come from `python3 -m mvsbench.control`
on the chip (PERF.md)."""

import pytest
import torch

from mvsbench import control
from mvsbench.cells import Cell
from mvsbench.check import verdict


def small(name):
    cell = Cell(name)
    cell.traffic.update(height=64, width=128, pool=4, check_views=2)
    if cell.driver != "serve":
        cell.traffic.update(views=3, batch=2)
    return cell


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 3100000002])
def test_serving_control_is_not_correct(seed):
    torch.set_num_threads(4)
    cell = small("dtu-test-serve")
    correct, table = verdict(control.serve_control(cell, seed, torch.device("cpu")), cell.limits)
    assert not correct, table


@pytest.mark.parametrize("cell_name", ["dtu-mid-train", "blendedmvs-train"])
def test_training_control_is_not_correct(cell_name):
    torch.set_num_threads(4)
    cell = small(cell_name)
    readings = control.train_controls(cell, 2**31 + 5, torch.device("cpu"))
    for kind in ("tf32", "half_batch"):
        correct, table = verdict(readings[kind], cell.limits)
        assert not correct, (kind, table)
