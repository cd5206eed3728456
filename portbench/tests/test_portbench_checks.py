"""Every cell's check fails the control and each fault that the cell can
have, at a size a test run holds (the control ran at the cells' own sizes
on the card: ``portbench.control``).

The control is the reference one precision below the configuration's;
the faults (``portbench.tests.faults``) alter an answer where it is made,
leave half of each call's words out, or leave the exchange between ranks
out.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.tests.small import small_cell, spec_json

REPO = Path(__file__).resolve().parents[2]
CONTROL = "portbench.reference.control:lower_precision"
CODEC = ["bf16-128Mi.graph", "f32-128Mi.graph", "bf16-512Mi.eager"]
GATHER = "allgather-falcon40b-layer.4chip"
CASES = ([(c, CONTROL) for c in CODEC + [GATHER]]
         + [(c, f"portbench.tests.faults:{f}") for c in CODEC for f in ("altered", "half")]
         + [(GATHER, f"portbench.tests.faults:{f}") for f in ("altered", "half", "no_exchange")])


def _cpu_run(cell, sut):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.tests.cpu_run", "--cell", spec_json(small_cell(cell)),
         "--seed", "3000000077", "--seconds", "0.3", "--sut", sut],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,sut", CASES)
def test_the_check_fails_a_broken_timed_path(cell, sut):
    line = _cpu_run(cell, sut)
    assert line["correct"] is False
    assert line["failed"] > 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
    assert list(line)[-1] == "checks"


@pytest.mark.gpu
def test_the_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.control", "--workload", "bf16-128Mi.graph",
         "--seconds", "1", "--seeds", "1", "2", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["every_run_not_correct"]
