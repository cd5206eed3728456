"""Small cells for the CPU tests: the benchmark's own configurations and
mixes, cut to sizes a test run holds."""

import copy
import json

from portbench.cells import ROOT, Cell, load_cell


def small_cell(name: str) -> Cell:
    """Cell `name` as the benchmark has it, at a small size."""
    cell = load_cell(name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if tr["driver"] == "codec":
        tr.update(words=3 * 4096, pool=2, trace_seconds=0.2)
    else:
        cfg["model"]["n_layer"] = 3
        cfg["layer"] = [["w_in", [48, 1024], "normal"], ["w_out", [1024, 40], "normal"],
                        ["ln.weight", [64], "ones"], ["ln.bias", [64], "zeros"]]
        tr.update(warm_calls=1, check_layers=2, trace_seconds=0.3)
    return Cell(cell.name, cell.chips, cfg, tr, ROOT)


def spec_json(cell: Cell) -> str:
    return json.dumps(cell.spec())
