"""The benchmark of dietgpu_tpu_torch, the PyTorch and CUDA port of dietTPU.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for. It makes its inputs on the card from the seed, warms up its own
shapes, measures for `seconds`, checks what the timed path produced, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared, with its limit, which also close
standard error. Without the cards, or where a process of the run has loaded
JAX or the JAX package, it prints no result and exits with another code
than 0.
"""

import argparse
import json
import sys
import time

from . import launch

NO_CARD, FORBIDDEN = 2, 3


def execute(cell, seed: int, seconds: float, trace_on: bool, sut_spec: str, dev_type: str,
            t_start: float) -> dict:
    """One run of `cell` on `dev_type` ("cuda" for a measurement; "cpu"
    only in the tests, through the port's CPU route). Returns the result
    line as a dict."""
    import torch

    from . import cells, device

    dev = torch.device(dev_type)
    outcome = cell.driver().run(cell, seed, seconds, trace_on, sut_spec, dev, t_start)
    bad = sorted(set(device.forbidden_modules()) | set(outcome.get("forbidden", [])))
    if bad:
        raise ForbiddenModules(bad)
    checks = outcome["checks"]
    power = device.power_limit() if dev.type == "cuda" else "not read"
    dev_info = device.describe(outcome["count"], outcome["memory_peak_bytes"], power)
    line = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": outcome["attempted"],
        "failed": outcome["failed"],
    }
    if trace_on:
        tr = outcome["trace"]
        line["metrics"] = cells.read_metrics(tr["ctx"], cell.root)
        dev_info["busy_s"], dev_info["window_s"] = tr["busy_s"], tr["window_s"]
        line["device"] = dev_info
        line["breakdown"] = tr["breakdown"]
    else:
        line["metrics"] = outcome["end_to_end"]
        line["device"] = dev_info
    line["checks"] = checks
    print(f"portbench: the check took {outcome['check_s']:.3f} s", file=sys.stderr)
    return line


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("JAX or the JAX package was loaded: " + ", ".join(names))


def emit(line: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    launch.guard()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import cells, device, sut

    cell = cells.load_cell(args.workload)
    try:
        device.require_cards(cell.chips)
        line = execute(cell, args.seed, args.seconds, bool(args.trace), sut.PROGRAM, "cuda",
                       t_start)
    except device.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return NO_CARD
    except ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return FORBIDDEN
    emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(launch.guarded(main))
