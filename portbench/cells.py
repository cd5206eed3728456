"""Finds a cell's files by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``) and the cards it takes; the mix names the driver
(``drivers/<driver>.py``) that runs it; every ``metrics/<metric>.py`` is a
per-layer reader. A new cell, configuration, mix or metric is new files,
and no file here changes.
"""

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r}: a name is 1-64 letters, digits, '_', '.', '-'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"unit {unit!r}: 1-16 letters, digits, '_', '/', '%', '.', '-'")
    return unit


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    root: Path = ROOT

    def driver(self):
        """The module that runs this cell's traffic mix."""
        return importlib.import_module(
            f"portbench.drivers.{check_name(self.traffic['driver'], 'driver')}")

    def spec(self) -> dict:
        """What a rank process needs to rebuild the cell."""
        return {"name": self.name, "chips": self.chips, "config": self.config,
                "traffic": self.traffic, "root": str(self.root)}

    @classmethod
    def from_spec(cls, spec: dict) -> "Cell":
        return cls(spec["name"], spec["chips"], spec["config"], spec["traffic"],
                   Path(spec["root"]))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    w = _load(root / "workloads" / f"{check_name(name, 'workload')}.json")
    config = _load(root / "configs" / f"{check_name(w['config'], 'config')}.json")
    traffic = _load(root / "traffic" / f"{check_name(w['traffic'], 'traffic')}.json")
    if w["chips"] not in (1, 4):
        raise ValueError(f"workload {name}: chips is 1 or 4")
    return Cell(name, w["chips"], config, traffic, root)


def readers(root: Path = ROOT) -> dict:
    """{metric name: reader module} for every ``metrics/<name>.py``. A
    reader has ``UNIT`` and ``read(ctx)``, which returns a number, or None
    where the run gave it nothing to read."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = check_name(path.stem, "metric")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        check_unit(mod.UNIT)
        out[name] = mod
    return out


def read_metrics(ctx: dict, root: Path = ROOT) -> dict:
    """Every reader's number for this run, {name: {value, unit}}; a reader
    that returns None is left out."""
    got = {}
    for name, mod in readers(root).items():
        v = mod.read(ctx)
        if v is not None:
            got[name] = {"value": v, "unit": mod.UNIT}
    return got
