"""``python -m nqbench.tests.rehearse <workload> <seed> <seconds> <trace>
<fault> <mode>``: one run of a cell on the CPU (the program's plain
versions of its kernels), with `fault` planted in the program first
(``faults.py``; 'none' for a sound run); prints the result line, or with
`mode` 'control' the readings ``nqbench.control`` takes."""

import json
import sys
import time

from nqbench import control, core, run
from nqbench.tests import faults


def main(argv):
    workload, seed, seconds, trace, fault, mode = argv
    cell = core.Cell(core.benchmark(), workload, int(seed), float(seconds),
                     int(trace), device="cpu")
    faults.plant(fault, cell)
    if mode == "control":
        print(json.dumps(control.readings(cell)))
    else:
        print(json.dumps(run.run_cell(cell, time.time())))


if __name__ == "__main__":
    main(sys.argv[1:])
