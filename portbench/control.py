"""Runs a cell with its control in the program's place, on the card:

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The control is the reference computed one precision below the
configuration's (``portbench.reference.control``); every run of it has to
come out not correct. Each seed's result line is printed, and the last
line says whether every run failed its checks. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time

from . import launch

CONTROL = "portbench.reference.control:lower_precision"


def main(argv=None) -> int:
    launch.guard(deadline_s=3000)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from . import cells, device, run

    cell = cells.load_cell(args.workload)
    device.require_cards(cell.chips)
    verdicts = []
    for seed in args.seeds:
        line = run.execute(cell, seed, args.seconds, False, CONTROL, "cuda", time.perf_counter())
        verdicts.append(line["correct"])
        print(json.dumps({"seed": seed, "correct": line["correct"], "checks": line["checks"]}),
              flush=True)
    print(json.dumps({"control": CONTROL, "workload": args.workload,
                      "every_run_not_correct": not any(verdicts)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(launch.guarded(main))
