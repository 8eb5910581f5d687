"""Readings that set the limits of a cell's comparisons: for each seed, in
one process, the program's numbers (a run's set-up and a short window at
the cell's own load, then the comparison a run makes) and the control's,
the plain reference in TF32 (the nearest precision below the
configuration's float32) in the program's place on the same inputs.

  python3 -m nqbench.control --workload <name> --seeds 1 2 3 \\
      [--seconds 2] [--out <file.jsonl>]

A training cell also reads the faults it can have, planted in the
reference put in the program's place: a state left unchanged, and in a
calibration cell half of each batch left out. One JSON line a seed on
stdout (and in --out). The benchmark's own runs do not run this."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from nqbench import core


def readings(cell) -> dict:
    driver = core.module("drivers", cell.traffic["driver"])
    st = driver.setup(cell)
    driver.window(st, cell, core.Trace(False))
    prog = {n: v for n, v, _ in driver.judge_run(st, cell)}
    diag = dict(getattr(st, "diag", {}))
    ctrl = {n: v for n, v, _ in driver.judge_run(st, cell, control=True)}
    out = {"seed": cell.seed, "program": prog, "control": ctrl,
           "program_leaves": diag}
    faults = {"calib": ("half_batch", "frozen"), "train": ("frozen",)}
    for fault in faults.get(cell.traffic["driver"], ()):
        out[fault] = {n: v for n, v, _ in driver.judge_run(
            st, cell, control=fault)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = core.benchmark()
    for seed in args.seeds:
        cell = core.Cell(bench, args.workload, seed, args.seconds, False)
        line = json.dumps(readings(cell))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
