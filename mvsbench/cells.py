"""Cells, configurations, traffic, references and metrics, found by name.

A cell `mvsbench/workloads/<cell>.json` names its configuration
(`mvsbench/configs/<config>.json`), its traffic (`mvsbench/traffic/
<traffic>.json`, read by traffic.py), its chips and the limits of its
correctness check.  Which end-to-end and per-layer metrics a cell reports
is read from BENCHMARK.json at the root, as the contract states it: a
metric that lists the cell under `workloads`, or one without that key
whose `moves` (for a per-layer metric) or own name (end to end) the cell
reports.  A per-layer metric is read by `mvsbench/metrics/<metric>.py`; a
kernel's roofline share `<kernel>_roofline.py` there also gives the
kernel's least seconds a unit, `least_s(cell)`.

A configuration holds `model`, the sizes of the cascade under the port's
CLI flag names, and for training `train`, the training flags; both go to
the port through its own parsers, and `model` to the reference too.  Its
top-level `reference` names the plain reference that judges it,
`mvsbench/reference/<name>.py` (`model` where the key is absent; the
modules' contract: mvsbench/reference/__init__.py).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REFERENCE_API = ("MODEL_KEYS", "config", "state_shapes", "forward")
MODULE_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def flags(options: dict) -> list[str]:
    """{"group_cor": true, "ndepths": "8,8,4,4"} -> ["--group_cor",
    "--ndepths", "8,8,4,4"]; false drops the flag."""
    out = []
    for key, value in options.items():
        if value is True:
            out.append(f"--{key}")
        elif value is not False:
            out += [f"--{key}", str(value)]
    return out


def reference_of(config: dict):
    """(the reference module that `config` names, its cfg of the
    configuration's `model`); ValueError where no reference module has that
    name, or the reference does not compute that model: a key it does not
    read, or a pinned key absent or at another value."""
    name = config.get("reference", "model")
    module = None
    if isinstance(name, str) and MODULE_NAME.fullmatch(name):
        try:
            module = importlib.import_module(f"mvsbench.reference.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"mvsbench.reference.{name}":
                raise
    missing = [a for a in REFERENCE_API if not hasattr(module, a)]
    if missing:
        raise ValueError(f"reference {name!r}: no module mvsbench/reference/{name}.py that "
                         f"provides {', '.join(missing)}")
    model = config["model"]
    for key, value in model.items():
        if key not in module.MODEL_KEYS:
            raise ValueError(f"model key {key!r} ({value!r}): reference {name!r} does not "
                             f"read it")
    for key, pinned in module.MODEL_KEYS.items():
        if pinned is not None and model.get(key, "absent") != pinned:
            raise ValueError(f"model key {key!r} is {model.get(key, 'absent')!r}: reference "
                             f"{name!r} computes {pinned!r} only")
    return module, module.config(model)


class Cell:
    def __init__(self, name: str, bench: dict | None = None):
        self.name = name
        spec = _json(HERE, "workloads", name + ".json")
        self.config_name = spec["config"]
        self.config = _json(HERE, "configs", spec["config"] + ".json")
        self.traffic_name = spec["traffic"]
        self.traffic = _json(HERE, "traffic", spec["traffic"] + ".json")
        self.chips = int(spec["chips"])
        self.limits = spec["limits"]
        self.reference, self.ref_config = reference_of(self.config)
        bench = bench if bench is not None else _json(ROOT, "BENCHMARK.json")
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.end_to_end = [m["name"] for m in e2e]
        self.per_layer = [m["name"] for m in bench["per_layer"]
                          if name in m.get("workloads", [])
                          or ("workloads" not in m and m["moves"] in self.end_to_end)]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    def weights(self, seed: int, device) -> dict:
        """The seeded state dict of every weight and buffer the reference
        lists (weights.seeded_state_dict), on the device."""
        from mvsbench.weights import seeded_state_dict

        return seeded_state_dict(self.reference.state_shapes(self.ref_config), seed, device)


def load_metric(name: str):
    """The reader module of a per-layer metric: LAYER, UNIT, MOVES and
    read(readings) -> float or None (nothing to read)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("mvsbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
