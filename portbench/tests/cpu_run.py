"""A run of a cell on the CPU, through the port's CPU route, for the tests:

    python -m portbench.tests.cpu_run (--cell JSON | --workload NAME) --seed N --seconds S
        [--trace 1] [--sut SPEC]

`--cell` is a cell's spec (``Cell.spec()``), usually a small one the test
built; `--workload` names a cell of this checkout's files. It skips the
look for a card, which ``portbench.run`` makes, and does everything else
a run does; it prints the result line the same way.
"""

import argparse
import json
import sys
import time

from portbench import launch


def main(argv=None) -> int:
    t_start = time.perf_counter()
    launch.guard()
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--cell")
    which.add_argument("--workload")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sut", default="portbench.sut:program")
    args = ap.parse_args(argv)

    from portbench import run
    from portbench.cells import Cell, load_cell

    cell = Cell.from_spec(json.loads(args.cell)) if args.cell else load_cell(args.workload)
    line = run.execute(cell, args.seed, args.seconds, bool(args.trace), args.sut, "cpu", t_start)
    run.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(launch.guarded(main))
