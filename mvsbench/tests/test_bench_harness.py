"""The harness stands alone and keeps to the benchmark's contract."""

import ast
import json
import os
import re
import subprocess
import sys
import types

import pytest

from mvsbench import cells, check, traffic, work
from mvsbench.cells import HERE, ROOT, Cell, load_metric
from mvsbench.reference import model as ref_model

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "mvster_tpu")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_importing_the_harness_loads_no_jax():
    probe = ("import sys, mvsbench.run, mvsbench.control, mvsbench.drivers.serve, "
             "mvsbench.drivers.train\n"
             "import mvster_tpu_torch.tools.test, mvster_tpu_torch.tools.train\n"
             "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert not set(out.stdout.split()) & set(FORBIDDEN)


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_torch_alone():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] in ("__future__", "math", "torch", "mvsbench"), (f, mod)
                assert not mod.startswith("mvsbench.") or mod.startswith("mvsbench.reference"), (f, mod)


def test_no_benchmark_file_imports_jax():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(d, f)):
                    assert mod.split(".")[0] not in FORBIDDEN, (f, mod)


def test_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["mvsbench"] and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        mod = load_metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"] == f"mvsbench/configs/{c['name']}.json" and not c["reduced"]
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_finds_its_files(cell):
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    c = Cell(cell, b)
    assert (c.config_name, c.traffic_name, c.chips) == (w["config"], w["traffic"], w["chips"])
    assert os.path.exists(os.path.join(HERE, "drivers", c.driver + ".py"))
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    for name in c.per_layer:
        assert callable(load_metric(name).read)
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.reference.__name__ == "mvsbench.reference." + c.config.get("reference", "model")


def test_without_a_card_it_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "mvsbench.run", "--workload", "dtu-test-serve",
                          "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


SMALL = dict(driver="serve", height=64, width=128, views=3, batch=1, pool=2,
             depth_range=[425.0, 935.0], focal_scale=1.1, max_angle=0.05, max_shift=30.0,
             gt=True, mask_share=0.8)


def probe_cell(tmp_path, monkeypatch, change):
    """The cell `probe` in folders of its own under tmp_path: mvster-dtu's
    configuration with `change` laid over it (its `model` merged), at a
    small size."""
    with open(os.path.join(HERE, "configs", "mvster-dtu.json")) as f:
        config = json.load(f)
    config.update({k: v for k, v in change.items() if k != "model"})
    config["model"].update(change.get("model", {}))
    files = {"configs": config, "traffic": SMALL,
             "workloads": {"config": "probe", "traffic": "probe", "chips": 1,
                           "limits": {"depth_off": 1e-6}}}
    for folder, content in files.items():
        os.makedirs(tmp_path / folder)
        with open(tmp_path / folder / "probe.json", "w") as f:
            json.dump(content, f)
    monkeypatch.setattr(cells, "HERE", str(tmp_path))
    return Cell("probe", bench())


@pytest.mark.parametrize("change, named", [
    ({"model": {"dcn": True}}, "'dcn'"),
    ({"model": {"reg_mode": "reg3d"}}, "'reg_mode'"),
    ({"model": {"inverse_depth": False}}, "'inverse_depth'"),
    ({"model": {"compute_dtype": "bfloat16"}}, "'compute_dtype'"),
    ({"reference": "reg3d"}, "'reg3d'"),
    ({"reference": "losses"}, "'losses'"),
    ({"reference": "../model"}, "'../model'"),
])
def test_a_configuration_its_reference_does_not_compute_is_refused(tmp_path, monkeypatch,
                                                                   change, named):
    """A model key the reference does not read, a pinned key at another
    value, or a reference that names no reference module: Cell raises,
    naming it, before anything touches a card."""
    with pytest.raises(ValueError, match=re.escape(named)):
        probe_cell(tmp_path, monkeypatch, change)


def test_a_pinned_key_left_out_is_refused(tmp_path, monkeypatch):
    """Left out, the port takes its own default (linear depth hypotheses),
    not the value the reference computes."""
    with open(os.path.join(HERE, "configs", "mvster-dtu.json")) as f:
        model = json.load(f)["model"]
    del model["inverse_depth"]
    with pytest.raises(ValueError, match="'inverse_depth' is 'absent'"):
        cells.reference_of({"model": model})


def test_the_named_reference_is_the_one_used(tmp_path, monkeypatch):
    """A configuration naming a reference of its own: the weights' shapes,
    the serving and training checks and the FLOPs all go through it."""
    from mvster_tpu_torch.data.loader import _stack_tree

    calls = []
    spy = types.ModuleType("mvsbench.reference.spy")
    spy.MODEL_KEYS = ref_model.MODEL_KEYS

    def recorded(name):
        def call(*args, **kwargs):
            calls.append(name)
            return getattr(ref_model, name)(*args, **kwargs)
        return call

    for name in ("config", "state_shapes", "forward"):
        setattr(spy, name, recorded(name))
    monkeypatch.setitem(sys.modules, "mvsbench.reference.spy", spy)
    cell = probe_cell(tmp_path, monkeypatch, {"reference": "spy"})
    assert cell.reference is spy and calls == ["config"]

    sd = cell.weights(3, "cpu")
    assert calls[1:] == ["state_shapes"]
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v) for k, v in ref_model.state_shapes(cell.ref_config).items()}
    samples = traffic.pool(cell.traffic, 3)
    answer = check.reference_answer(cell.reference, sd, cell.ref_config, samples[0], "cpu")

    calls.clear()
    values = check.judge_views(cell.reference, sd, cell.ref_config, [(samples[0], answer)],
                               "cpu")
    assert calls == ["forward"] and values["depth_off"] == 0

    calls.clear()
    check.reference_steps(cell.reference, sd, cell.ref_config, [_stack_tree(samples)], 1e-3,
                          2, "cpu")
    assert calls == ["forward"]

    calls.clear()
    assert work.reference_flops(cell.reference, cell.ref_config, 64, 128, 3, 1, False) > 0
    assert calls == ["state_shapes", "forward"]
