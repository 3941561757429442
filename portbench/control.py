"""The controls of a cell's correctness check: the cell run with one
guarantee of its configuration broken (each of the configuration's
"controls"), judged by the same reference against the configuration's
stated flags.  Each must come out not correct, and together they give each
number that is not exact its upper reading.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds <s> [--controls a,b]

prints, for each control (or each one named) and seed, the numbers compared with their limits
and whether the run came out correct.  The benchmark's own runs never run
it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = run.Cell(a.workload)
    names = set(filter(None, a.controls.split(",")))
    for ctl in cell.cfg["controls"]:
        if names and ctl["name"] not in names:
            continue
        for seed in (int(s) for s in a.seeds.split(",")):
            result, checks = run.run_cell(a.workload, seed, a.seconds, False,
                                          extra_flags=ctl["flags"])
            print(json.dumps({"workload": a.workload, "control": ctl["name"],
                              "seed": seed, "correct": result["correct"],
                              "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
