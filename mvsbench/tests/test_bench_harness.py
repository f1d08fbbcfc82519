"""The harness stands alone and keeps to the benchmark's contract."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from mvsbench.cells import HERE, ROOT, Cell, load_metric

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


def test_without_a_card_it_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "mvsbench.run", "--workload", "dtu-test-serve",
                          "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
