"""No process of a multi-rank run outlives it: after a normal end, after a
rank raises, and after the run is sent SIGTERM in its window.

Each case runs the all-gather cell at a small size over gloo on the CPU
(``portbench.tests.cpu_run``, which is ``portbench.run`` without the look
for a card), in a session of its own, and then scans ``/proc/*/stat`` for
any process of that session.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench.tests.small import small_cell, spec_json

REPO = Path(__file__).resolve().parents[2]
CELL = "allgather-falcon40b-layer.4chip"


def _session_members(sid: int) -> list:
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2 :].split()
        if int(fields[3]) == sid:  # fields: state, ppid, pgrp, session
            found.append((int(entry), stat[: stat.rindex(")") + 1]))
    return found


def _start(sut: str, seconds: float, env=None):
    cmd = [sys.executable, "-m", "portbench.tests.cpu_run", "--cell", spec_json(small_cell(CELL)),
           "--seed", "3000000041", "--seconds", str(seconds), "--sut", sut]
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True, env={**os.environ, **(env or {})})


def _assert_session_empty(proc) -> None:
    sid = proc.pid  # the leader of a new session has the session's id
    end = time.monotonic() + 10
    while _session_members(sid) and time.monotonic() < end:
        time.sleep(0.2)
    assert _session_members(sid) == []


def _last_json(out: str):
    lines = [x for x in out.strip().splitlines() if x.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def test_normal_end_leaves_no_process():
    proc = _start("portbench.sut:program", 1.0)
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    line = _last_json(out)
    assert line["correct"] and line["device"]["count"] == 4
    _assert_session_empty(proc)


def test_a_rank_that_raises_ends_the_run_without_a_result():
    proc = _start("portbench.tests.faults:rank2_raises", 5.0)
    out, err = proc.communicate(timeout=240)
    assert proc.returncode != 0
    assert _last_json(out) is None
    assert "a rank raises" in err
    _assert_session_empty(proc)


@pytest.mark.parametrize("sig", [signal.SIGTERM])
def test_a_signal_in_the_window_ends_every_rank(tmp_path, sig):
    mark = tmp_path / "window"
    proc = _start("portbench.tests.faults:marks_window", 120.0,
                  env={"PORTBENCH_TEST_MARK": str(mark)})
    end = time.monotonic() + 180
    while not mark.exists():
        assert proc.poll() is None, proc.communicate()[1][-3000:]
        assert time.monotonic() < end, "the window never opened"
        time.sleep(0.2)
    time.sleep(1.0)
    assert len(_session_members(proc.pid)) >= 4  # rank 0 and its three ranks
    proc.send_signal(sig)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 128 + sig
    assert _last_json(out) is None
    _assert_session_empty(proc)


def test_a_rank_that_ends_before_rank_0_is_no_failure():
    """A rank that has put its result and exits with 0 while rank 0 still
    checks its own part does not end the run."""
    script = (
        "import subprocess, sys, time\n"
        "from portbench import launch\n"
        "launch.guard()\n"
        "p = subprocess.Popen([sys.executable, '-c', 'pass'])\n"
        "launch._ranks.append(p)\n"
        "time.sleep(2.0)\n"
        "print('rank 0 went on')\n"
        "launch.finish([p])\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "rank 0 went on" in out.stdout
