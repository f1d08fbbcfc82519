"""Cells, configurations, traffic and metrics, found by name.

A cell `mvsbench/workloads/<cell>.json` names its configuration
(`mvsbench/configs/<config>.json`), its traffic (`mvsbench/traffic/
<traffic>.json`, read by traffic.py), its chips and the limits of its
correctness check.  Which end-to-end and per-layer metrics a cell reports
is read from BENCHMARK.json at the root, as the contract states it: a
metric that lists the cell under `workloads`, or one without that key
whose `moves` (for a per-layer metric) or own name (end to end) the cell
reports.  A per-layer metric is read by `mvsbench/metrics/<metric>.py`.

A configuration holds `model`, the sizes of the cascade under the port's
CLI flag names, and for training `train`, the training flags; both go to
the port through its own parsers, and `model` to the reference too.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


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


def reference_config(model: dict):
    from mvsbench.reference.model import Config

    ints = lambda s: tuple(int(x) for x in str(s).split(","))  # noqa: E731
    return Config(ndepths=ints(model["ndepths"]),
                  depth_inter_r=tuple(float(x) for x in str(model["depth_inter_r"]).split(",")),
                  group_cor_dim=ints(model["group_cor_dim"]),
                  fpn_base=int(model["fpn_base_channel"]), reg_base=int(model["reg_channel"]),
                  attn_temp=float(model["attn_temp"]), mono=bool(model.get("mono")))


class Cell:
    def __init__(self, name: str, bench: dict | None = None):
        self.name = name
        spec = _json(HERE, "workloads", name + ".json")
        self.config_name = spec["config"]
        self.config = _json(HERE, "configs", spec["config"] + ".json")
        self.traffic_name = spec["traffic"]
        from mvsbench import traffic

        self.traffic = traffic.load(spec["traffic"])
        self.chips = int(spec["chips"])
        self.limits = spec["limits"]
        self.ref_config = reference_config(self.config["model"])
        bench = bench if bench is not None else _json(ROOT, "BENCHMARK.json")
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.end_to_end = [m["name"] for m in e2e]
        self.per_layer = [m["name"] for m in bench["per_layer"]
                          if name in m.get("workloads", [])
                          or ("workloads" not in m and m["moves"] in self.end_to_end)]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_metric(name: str):
    """The reader module of a per-layer metric: LAYER, UNIT, MOVES and
    read(readings) -> float or None (nothing to read)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("mvsbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
