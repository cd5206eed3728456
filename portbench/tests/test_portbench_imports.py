"""Nothing a run loads is JAX or the JAX package, and the reference
imports nothing of the program.

Each cell's mix runs its set-up and a short window at a small size on the
CPU, through the port's CPU route, in a subprocess of its own (rank 0
reports what every rank loaded, and a run that finds JAX or the JAX
package refuses to print a result). Module names are compared by their
top-level part, whole: ``dietgpu_tpu_torch`` is not ``dietgpu_tpu``.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import device
from portbench.tests.small import small_cell, spec_json

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "portbench"
CELLS = sorted(p.stem for p in (PB / "workloads").glob("*.json"))


def _cpu_run(cell, sut="portbench.sut:program", seconds=0.3):
    return subprocess.run(
        [sys.executable, "-m", "portbench.tests.cpu_run", "--cell", spec_json(small_cell(cell)),
         "--seed", "2147483659", "--seconds", str(seconds), "--sut", sut],
        cwd=REPO, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    out = _cpu_run(cell)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]


def test_a_run_that_loaded_the_jax_package_prints_no_result():
    out = _cpu_run(CELLS[0], sut="portbench.tests.faults:loads_jax_package")
    assert out.returncode != 0
    assert "dietgpu_tpu" in out.stderr
    assert not [x for x in out.stdout.splitlines() if x.startswith("{")]


def test_names_are_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "dietgpu_tpu_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert device.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert device.forbidden_modules() == ["jax.numpy"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").glob("*.py"):
        assert not _imports(path) & {"dietgpu_tpu_torch", "dietgpu_tpu", "jax", "portbench"}, path


def test_the_harness_imports_no_jax():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "dietgpu_tpu"}, path


def test_no_test_file_shares_a_name_with_the_repos_tests():
    ours = {p.name for p in (PB / "tests").glob("*.py")} - {"__init__.py", "conftest.py"}
    assert all(n.startswith("test_portbench_") for n in ours if n.startswith("test_"))
    assert not ours & {p.name for p in (REPO / "tests").glob("*.py")}
