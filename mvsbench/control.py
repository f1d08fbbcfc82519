"""Readings that set a cell's limits: the program's over many seeds, and the
control's and the planted faults' over a few.

    python3 -m mvsbench.control --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 3] [--out chiprun_out/control.json]

For each seed the program runs as a run of the cell does (set-up, a short
window at the cell's load, the check) and its numbers are read.  The
control is the reference put in the program's place and computed in the
nearest precision below the configuration's (float32 with TF32 off):
every convolution from TF32 operands (the reference's `cfg.lower`).  A
training cell also reads the fault of half of each batch left out (the
reference on the first half of each batch's rows, the mean over those).
Each is judged by the same comparison as the program, against the float32
reference.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import os

import torch

from mvsbench import check, traffic
from mvsbench.cells import Cell
from mvsbench.common import free_cuda, process_start, say


def lowered(cfg):
    low = copy.copy(cfg)
    low.lower = "tf32"
    return low


def program(cell, seed, seconds, device) -> dict:
    driver = importlib.import_module(f"mvsbench.drivers.{cell.driver}")
    res = driver.run(cell, seed, seconds, False, device, process_start())
    free_cuda()
    return res["values"]


def serve_control(cell, seed, device) -> dict:
    ref, sd = cell.reference, cell.weights(seed, device)
    samples = traffic.pool(cell.traffic, seed)[:cell.traffic["check_views"]]
    low = lowered(cell.ref_config)
    answers = [check.reference_answer(ref, sd, low, s, device) for s in samples]
    return check.judge_views(ref, sd, cell.ref_config, list(zip(samples, answers)), device)


def half(batch):
    if isinstance(batch, dict):
        return {k: half(v) for k, v in batch.items()}
    return batch[: max(1, len(batch) // 2)]


def train_controls(cell, seed, device) -> dict:
    from mvsbench.drivers.train import loader_of

    ref, sd = cell.reference, cell.weights(seed, device)
    loader = loader_of(cell, seed)
    loader.set_epoch(0)
    batches = []
    for b in loader:
        batches.append(b)
        if len(batches) == 3:
            break
    lr = float(cell.config["train"]["lr"])
    iters = int(cell.config["train"]["ot_iter"])
    sound = check.reference_steps(ref, sd, cell.ref_config, batches, lr, iters, device)
    halved = check.reference_steps(ref, sd, cell.ref_config, [half(b) for b in batches], lr,
                                   iters, device)
    low = check.reference_steps(ref, sd, lowered(cell.ref_config), batches, lr, iters, device)
    # judged as a run judges the program: the reference on the control's windows
    ref_low = check.reference_steps(ref, sd, cell.ref_config, batches, lr, iters, device,
                                    low["stage_depths"])
    return {"tf32": check.judge_steps(low, ref_low),
            "half_batch": check.judge_steps(halved, sound)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    table = {"cell": cell.name, "program": {}, "control": {}}
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        table["control"][seed] = (serve_control if cell.driver == "serve"
                                  else train_controls)(cell, seed, device)
        say(f"control seed {seed}: {json.dumps(table['control'][seed])}")
        free_cuda()
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        table["program"][seed] = program(cell, seed, args.seconds, device)
        say(f"program seed {seed}: {json.dumps(table['program'][seed])}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    print(json.dumps(table))


if __name__ == "__main__":
    main()
