"""Readings for a cell's correctness limits, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 3]

Runs the cell once a seed in one process, with a short window at the
cell's own sizes and load, and prints one JSON line a run: every number
the check read, whether the run came out correct under the cell's current
limits, and its end-to-end metrics. With ``--control-seeds`` it then puts
the control (one precision below the configuration's) in the program's place on
those seeds. The lower reading of a number is the largest the program
gives, the upper the smallest the control gives; the benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    device = torch.device("cuda", 0)
    sides = [(int(s), False) for s in args.seeds.split(",")]
    sides += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in sides:
        result = run.run_cell(cell, seed, args.seconds, False, device, control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control" if control else "program",
                          "numbers": result["numbers"], "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"],
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "peak": result["device"]["memory_peak_bytes"]}), flush=True)
    print(run.card_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
