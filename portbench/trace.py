"""The benchmark's traced windows: torch.profiler over the host and the
card, reduced to the few numbers that the per-layer readers take.

A window is a ``torch.profiler.profile`` (CPU activity, and CUDA where a
card is present) with a host range ``portbench.window.<label>`` around the
work, which ends in a synchronize; its ends bound the window on the
trace's clock. After it closes, the trace is exported as a Chrome trace
into a temporary file, read back, deleted, and reduced:

- device work: every kernel, copy and fill that ran inside the window
  (clipped to it); busy is the union of their intervals, so it never
  exceeds the window however many streams ran;
- device time by operation name, and that of the NCCL kernels apart;
- the host's stage ranges of the program (``dietgpu.*``) and the time
  they cover;
- the top-level aten ops: those that no other op encloses;
- the idle gaps, each labelled by what the host was doing at its middle:
  the innermost ``dietgpu.*`` range, else the innermost torch op, else
  the CUDA runtime call, else "(python)".
"""

import gzip
import json
import os
import tempfile
from bisect import bisect_right
from pathlib import Path

import torch

WINDOW_PREFIX = "portbench.window."
STAGE_PREFIX = "dietgpu."
GLUE_STAGES = ("dietgpu.float.", "dietgpu.ans.")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 96  # an operation's name is cut to this many characters in a breakdown


class Window:
    """``with Window(label, on) as w:`` traces the block when `on`; the
    block must end in a synchronize. ``w.summary`` is None when off.
    `before`, if given, is called on entry, after the profiler has started
    and before the window opens."""

    def __init__(self, label: str, on: bool, before=None):
        self.label = WINDOW_PREFIX + label
        self.on = on
        self.before = before
        self.summary = None
        self._prof = self._range = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        if self.before is not None:
            self.before()
        if self.on:
            self._range = torch.profiler.record_function(self.label)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce_events(_export(self._prof), self.label)
        return False


def _export(prof) -> list:
    """The profiler's events as Chrome trace events (the file is deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        opener = gzip.open if Path(path).read_bytes()[:2] == b"\x1f\x8b" else open
        with opener(path, "rt") as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Innermost:
    """The innermost of a set of nested intervals that covers a time: the
    last to start at or before it, or the nearest of its enclosers that
    covers it."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.ev]
        self.parent, stack = [], []
        for i, e in enumerate(self.ev):
            while stack and self.ev[stack[-1]]["ts"] + self.ev[stack[-1]]["dur"] <= e["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def at(self, t):
        i = bisect_right(self.starts, t) - 1
        while i is not None and i >= 0:
            e = self.ev[i]
            if e["ts"] + e["dur"] >= t:
                return e
            i = self.parent[i]
        return None


def _top_level(ops) -> int:
    """The aten ops among `ops` (one thread's ops) that no op encloses."""
    count, stack = 0, []
    for e in sorted(ops, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1] <= e["ts"]:
            stack.pop()
        if not stack and e["name"].startswith("aten::"):
            count += 1
        stack.append(e["ts"] + e["dur"])
    return count


def reduce_events(events, label) -> dict:
    """The numbers of one window (seconds unless named otherwise)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == label and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"trace: expected one {label} range, found {len(win)}")
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]

    dev = []
    for e in xs:
        if e.get("cat") in _DEVICE_CATS:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b > a:
                dev.append((e["name"], a, b))
    busy = _union((a, b) for _, a, b in dev)
    by_name = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    nccl = sum(v for k, v in by_name.items() if k.startswith("nccl"))

    host = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                                               "cuda_driver") and e["ts"] < t1
            and e["ts"] + e["dur"] > t0 and e is not win[0]]
    stages = [e for e in host if e.get("cat") == "user_annotation"
              and e["name"].startswith(STAGE_PREFIX)]
    glue = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in stages
                  if e["name"].startswith(GLUE_STAGES))
    ops_by_tid = {}
    for e in host:
        if e.get("cat") == "cpu_op":
            ops_by_tid.setdefault(e.get("tid"), []).append(e)

    holes, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    finders = [_Innermost(stages), _Innermost([e for e in host if e.get("cat") == "cpu_op"]),
               _Innermost([e for e in host if e.get("cat") in ("cuda_runtime", "cuda_driver")])]
    gaps = {}
    for a, b in holes:
        hits = (f.at((a + b) / 2) for f in finders)
        name = next((h["name"] for h in hits if h is not None), "(python)")
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_s": sum(by_name.values()),
        "nccl_s": nccl,
        "device_ops": by_name,
        "idle_gaps": gaps,
        "stage_ranges": len(stages),
        "glue_s": sum(b - a for a, b in glue) / 1e6,
        "top_level_aten_ops": sum(_top_level(v) for v in ops_by_tid.values()),
    }


def top(d: dict, k: int = 10) -> list:
    """The k largest entries of {name: seconds}, as [name, seconds] pairs."""
    return [[n[:NAME_CHARS], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def merge(summaries) -> dict:
    """Several windows' summaries as one: sums of each number and of each
    name's seconds."""
    out = {}
    for s in summaries:
        for k, v in s.items():
            if isinstance(v, dict):
                acc = out.setdefault(k, {})
                for n, x in v.items():
                    acc[n] = acc.get(n, 0.0) + x
            else:
                out[k] = out.get(k, 0) + v
    return out
