"""The two readings each limit of ``limits/<cell>.json`` is set from, at the
cell's own size on the card:

* the program's: one call of the cell on each seed, held to the plain
  reference in the configuration's precision (what every run compares);
* the control's: the plain reference itself computed in the next precision
  down (float32 for the configurations' float64), put in the program's
  place and held to the same reference.

    python3 benchmark/calibrate.py --workload <cell> --seeds <a,b,...> [--control_seeds <...>]

Prints one JSON line a seed and side, then the largest program reading and
the smallest control reading of each number. The benchmark's own runs never
run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.run import Spec  # noqa: E402


def readings(spec: Spec, seed: int, device, control: bool, dtype_low=torch.float32) -> dict:
    """``{"program": {...}, "control": {...} or None}`` of one seed; call 0
    of the seed's pool on both sides."""
    cell = spec.entry().Cell(spec.config, spec.traffic, seed, device)
    start = time.perf_counter()
    cell.call(0)
    program_s = time.perf_counter() - start
    start = time.perf_counter()
    truth = cell.reference(0)
    reference_s = time.perf_counter() - start
    out = {"seed": seed, "program": cell.compare(0, cell.answers[0], truth),
           "program_s": program_s, "reference_s": reference_s, "control": None}
    if control:
        out["control"] = cell.compare(0, cell.reference(0, dtype_low), truth)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds for the program")
    p.add_argument("--control_seeds", default="", help="seeds among them that also run the control")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        spec = Spec(json.load(f), args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    program, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(spec, seed, device, seed in controls)
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            program[k] = max(program.get(k, 0.0), v)
        for k, v in (r["control"] or {}).items():
            control[k] = min(control.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "program_max": program, "control_min": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
