"""MVSTER with deformable-conv heads (`--dcn`) against its plain reference,
mvsbench/reference/dcn.py, on the CPU at a small size: the port's model
built from the configuration's flags, on the benchmark's seeded weights
(whose offset convs move the taps by whole pixels), judged by the serving
check's three numbers under the cell's own limits; the model that the
configuration builds loads the reference's state dict strictly; a run of
the cell with the port's offsets forced to zero (a plain modulated conv in
each head's place) and the TF32 control both come out not correct; the
heads' least time at the cell's shapes."""

import pytest
import torch

from mvsbench import control, traffic, weights
from mvsbench.cells import Cell, load_metric
from mvsbench.check import judge_view, serve_inputs, verdict
from mvsbench.drivers import serve
from mvsbench.run import measure

CELL = "dtu-test-serve-dcn"
SMALL = dict(height=64, width=128, views=3, pool=4, warmup=3, check_views=2,
             trace_after=1, trace_count=2)


def small():
    cell = Cell(CELL)
    cell.traffic.update(SMALL)
    return cell


def answer_of(out):
    """The port's forward output as infer_views hands a view out (numpy)."""
    ans = {f"stage{s}_{k}": out[f"stage{s}"][v].numpy()
           for s in (1, 2, 3) for k, v in (("depth", "depth"), ("conf", "photometric_confidence"))}
    ans["depth"] = out["stage4"]["depth"].numpy()
    ans["confidence"] = out["stage4"]["photometric_confidence"].numpy()
    return ans


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_the_port_matches_the_reference(seed):
    torch.set_num_threads(4)
    cell = small()
    sd = cell.weights(seed, "cpu")
    model = serve.port_model(cell.config)
    model.load_state_dict(sd, strict=True)
    model.eval()
    offsets = []
    hooks = [model.feature.get_submodule(f"dcn{s}.2.p_conv").register_forward_hook(
        lambda _m, _a, out: offsets.append(out.abs().mean())) for s in (1, 2, 3, 4)]
    sample = traffic.pool(cell.traffic, seed)[0]
    imgs, projs, dv = serve_inputs(sample, "cpu")
    with torch.no_grad():
        out = model(imgs, projs, dv)
    for h in hooks:
        h.remove()
    assert min(offsets) > 0.3, offsets  # taps moved by pixels, not by rounding
    values = judge_view(cell.reference, sd, cell.ref_config, sample, answer_of(out), "cpu")
    correct, table = verdict(values, cell.limits)
    assert correct, table


def test_the_configuration_loads_the_reference_state_strictly():
    cell = small()
    model = serve.port_model(cell.config)
    sd = weights.seeded_state_dict(cell.reference.state_shapes(cell.ref_config), 1, "cpu")
    model.load_state_dict(sd, strict=True)
    assert sum(k.startswith("feature.dcn") for k in sd) == 4 * 10


def test_a_sound_run_is_correct():
    torch.set_num_threads(4)
    line = measure(small(), 2**31 + 101, 1.5, False, torch.device("cpu"))
    assert line["correct"], line["checks"]


def zero_offsets(port_model):
    """The port's model with every deformable head's offsets forced to zero."""
    def built(config):
        model = port_model(config)
        for s in (1, 2, 3, 4):
            model.feature.get_submodule(f"dcn{s}.2.p_conv").register_forward_hook(
                lambda _m, _a, out: torch.zeros_like(out))
        return model
    return built


def test_zero_offsets_are_not_correct(monkeypatch):
    torch.set_num_threads(4)
    monkeypatch.setattr(serve, "port_model", zero_offsets(serve.port_model))
    line = measure(small(), 2**31 + 101, 1.5, False, torch.device("cpu"))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_the_tf32_control_is_not_correct(seed):
    torch.set_num_threads(4)
    cell = small()
    correct, table = verdict(control.serve_control(cell, seed, torch.device("cpu")), cell.limits)
    assert not correct, table


def test_least_time_of_the_heads():
    """About 62 GFLOP and 0.58 GB a forward at 832x1152, 5 views: compute-bound
    at each head, 0.93 ms."""
    assert load_metric("dcn_roofline").least_s(Cell(CELL)) == 0.0009282795367164179
