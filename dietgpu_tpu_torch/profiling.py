"""Profiler capture and the codec's stage ranges, on torch.profiler and NVTX.

Counterpart of ``dietgpu_tpu.profiling`` (the reference's
profilerStart/profilerStop, utils/DeviceUtils.cpp:48-54):

  * ``profiler_start(logdir)`` / ``profiler_stop()`` run a
    ``torch.profiler.profile`` over the CPU, and over CUDA where a card is
    present, and write its trace into ``logdir`` through
    ``torch.profiler.tensorboard_trace_handler`` (a Chrome trace that
    TensorBoard and Perfetto read). A second start, or a stop without a
    start, raises RuntimeError, as ``jax.profiler`` does.
  * ``annotate(name, cuda=False)`` and ``trace_annotation(name,
    cuda=False)`` mark a range named ``dietgpu.<name>`` while a profiler
    records: a ``torch.profiler.record_function``, and an NVTX range when
    ``cuda`` (the caller's tensors are on the card). Under Nsight Systems,
    run the code inside ``torch.autograd.profiler.emit_nvtx()``, which
    turns the ranges on, and the stages show on its timeline. The codec
    wraps its stages in them under the JAX package's names (split, stats,
    encode kernel, sections, assembly, fused decode+join).
  * ``read_trace(logdir)`` and ``stage_account(events)`` read such a
    capture back and attribute its host and device time to the stages.

A ``record_function`` costs about 7 us of host time even when no profiler
records, an NVTX push and pop about 1 us, and the compress paths are
host-bound with six ranges a call, so a range does nothing unless a
profiler records: it then costs about 1 us, its object and a flag check.

The ranges are host events around a call's launches: under a CUDA graph
capture they run once, at the capture, and a replay of the graph runs the
kernels without them.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path

import torch

STAGE_PREFIX = "dietgpu."
OUTSIDE = "(outside the stages)"  # stage_account's row of unstaged device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

_active = None  # the running torch.profiler.profile, if any


def profiler_start(logdir: str) -> None:
    """Begin a profiler capture whose trace goes into `logdir` (reference:
    profilerStart via cudaProfilerStart, DeviceUtils.cpp:48-51)."""
    global _active
    if _active is not None:
        raise RuntimeError("a profile has already been started; only one may run at a time")
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    _active = prof


def profiler_stop() -> None:
    """End the capture and write its trace (reference: profilerStop,
    DeviceUtils.cpp:53-54). Synchronises the card first, so that every
    kernel launched in the capture is in the trace."""
    global _active
    if _active is None:
        raise RuntimeError("no profile started")
    prof, _active = _active, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


class annotate:
    """A stage range ``dietgpu.<name>`` for profiler timelines, entered
    with ``with``, that does nothing unless a profiler records; `cuda`
    adds an NVTX range (for tensors on the card)."""

    __slots__ = ("name", "cuda", "_range")

    def __init__(self, name: str, cuda: bool = False):
        self.name = STAGE_PREFIX + name
        self.cuda = cuda
        self._range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            if self.cuda:
                torch.cuda.nvtx.range_push(self.name)
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
            if self.cuda:
                torch.cuda.nvtx.range_pop()
        return False


# In JAX a named scope tags traced code and a TraceAnnotation the host's
# timeline; PyTorch runs eagerly, so one range serves both.
trace_annotation = annotate


def read_trace(logdir) -> list:
    """The events of the one trace that ``profiler_stop`` wrote into
    `logdir` (a Chrome trace, gzipped or not)."""
    files = sorted(Path(logdir).glob("*.pt.trace.json*"))
    if len(files) != 1:
        raise RuntimeError(f"expected one trace in {logdir}, found {[f.name for f in files]}")
    opener = gzip.open if files[0].suffix == ".gz" else open
    with opener(files[0], "rt") as f:
        return json.load(f)["traceEvents"]


def stage_account(events) -> tuple:
    """Attribute a trace's time to the ``dietgpu.*`` stage ranges.

    Returns (rows, launches). rows: {stage name without the prefix: {calls,
    host_ms, host_self_ms, device_ms, device_self_ms}}, host_ms the sum of
    the range's lengths, host_self_ms less the stages nested in it,
    device_ms the device time (kernels, copies, memsets) launched inside
    it, device_self_ms of that launched in no nested stage; OUTSIDE holds
    the device events launched in no stage. launches: (device event name,
    the innermost stage its launch fell in or None, ms) for every device
    event, matched to its launch (a CUDA runtime or driver call) by the
    trace's correlation id.
    """
    stages = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith(STAGE_PREFIX)),
                    key=lambda e: (e["ts"], -e["dur"]))

    def innermost(t):
        """The range containing time t that starts last (the innermost)."""
        best = None
        for s in stages:
            if s["ts"] <= t <= s["ts"] + s["dur"]:
                best = s
        return best

    rows = {}

    def row(s):
        name = OUTSIDE if s is None else s["name"][len(STAGE_PREFIX):]
        return rows.setdefault(name, {"calls": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                      "device_ms": 0.0, "device_self_ms": 0.0})

    parent = {}
    for i, s in enumerate(stages):  # a range's container comes before it
        p = None
        for c in stages[:i]:
            if c["ts"] + c["dur"] >= s["ts"] + s["dur"]:
                p = c
        parent[id(s)] = p
        r = row(s)
        r["calls"] += 1
        r["host_ms"] += s["dur"] / 1e3
        r["host_self_ms"] += s["dur"] / 1e3
        if p is not None:
            row(p)["host_self_ms"] -= s["dur"] / 1e3
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    launches = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        s = None if t is None else innermost(t)
        ms = e["dur"] / 1e3
        launches.append((e["name"], None if s is None else s["name"][len(STAGE_PREFIX):], ms))
        row(s)["device_self_ms"] += ms
        while s is not None:
            row(s)["device_ms"] += ms
            s = parent[id(s)]
    rows.setdefault(OUTSIDE, {"calls": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                              "device_ms": 0.0, "device_self_ms": 0.0})
    rows[OUTSIDE]["device_ms"] = rows[OUTSIDE]["device_self_ms"]
    return rows, launches
