"""Readings that the limits of a cell's correctness check are set from.

    python3 -m benchmark.calibrate --workload <cell> --seeds s1,s2,... \\
        --control-seeds c1,c2,c3 --seconds <s>

Builds the program once, then runs the cell's window of `--seconds` and its
check on each seed (fresh weights, requests and draws from the seed); on
the control seeds it also reads the control, the reference one precision
step below the configuration's (`benchmark/reference/layers.py::fp8_` and
bfloat16 sampler arithmetic), on the same clips. Prints one JSON line per
seed and, last, the lower reading of each number (the largest the program
gave) and the upper one (the smallest the control gave). Not part of a
benchmark run; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--fault", default=None,
                   help="plant this fault of benchmark/faults.py in the program")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    traffic = harness.traffic_module(cell.entry["traffic"])
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    program = traffic.program_factory(cell, device)
    fault = None
    if args.fault:
        from benchmark import faults
        fault = (faults.TRAINING if cell.entry["traffic"] == "finetune"
                 else faults.GENERATION)[args.fault]
    lower, upper = {}, {}
    for seed in sorted(set(seeds) | controls):
        t0 = time.perf_counter()
        result, checks = traffic.run(cell, seed=seed, seconds=args.seconds, trace=False,
                                     device=device, clock=harness.SetupClock(time.perf_counter()),
                                     program=program, control=seed in controls, fault=fault)
        line = {"seed": seed, "correct": result["correct"], "attempted": result["attempted"],
                "program": {k: c["value"] for k, c in checks.items()},
                "control": result.get("control"), "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if seed in seeds:
            for k, c in checks.items():
                value = c["value"] if c["value"] is not None else float("inf")
                lower[k] = max(lower.get(k, 0.0), value)
        for k, v in (result.get("control") or {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"lower": lower, "upper": upper, "seeds": len(seeds),
                      "control_seeds": len(controls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
