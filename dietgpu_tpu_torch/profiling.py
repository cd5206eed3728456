"""Profiler capture, the program's spans and counters, on torch.profiler
and NVTX.

Counterpart of ``dietgpu_tpu.profiling`` (the reference's
profilerStart/profilerStop, utils/DeviceUtils.cpp:48-54):

  * ``profiler_start(logdir)`` / ``profiler_stop()`` run a
    ``torch.profiler.profile`` over the CPU, and over CUDA where a card is
    present, and write its trace into ``logdir`` through
    ``torch.profiler.tensorboard_trace_handler`` (a Chrome trace that
    TensorBoard and Perfetto read). A second start, or a stop without a
    start, raises RuntimeError, as ``jax.profiler`` does.
  * ``annotate(name, cuda=False, call=None)`` is a span ``<name>``: while
    a profiler records it enters a ``torch.profiler.record_function``
    named ``dietgpu.<name>`` (its twin), and an NVTX range of that name
    when ``cuda`` (the caller's tensors are on the card); under Nsight
    Systems, run the code inside ``torch.autograd.profiler.emit_nvtx()``,
    which turns them on. The codec wraps its stages in spans under the JAX
    package's names (split, stats, encode kernel, sections, assembly,
    fused decode+join), and the byte path's histogram pass and raw decode
    in ``ans.hist`` and ``ans.decode``, which the JAX package leaves
    unlabelled; the front end's public entry points run inside
    ``front.compress`` / ``front.decompress`` (:func:`entry`), and each
    collective's stages inside ``collective.compress``, ``.vote``,
    ``.exchange`` and ``.decode``.
  * The recorder: while a profiler records, inside ``record_spans()``, or
    for the whole process when ``DIETGPU_SPANS_DIR`` is set at import,
    each span that ends appends one record to a ring of the last
    ``SPAN_LIMIT``: its id, name, parent span, call id (its root span's
    id, or the collective call's id that the caller gave), start and end
    (ns on the Unix epoch, from ``time.perf_counter_ns()`` through one
    anchor pair taken at import), thread, whether a profiler recorded, and
    the counters' increments made while it was the innermost open span.
    :func:`spans` reads the ring. With ``DIETGPU_SPANS_DIR`` set, the
    process writes it as JSON lines to ``<dir>/spans.<pid>.jsonl`` at exit.
    A torch Chrome trace's ``ts`` (us) of an instant is ``epoch_ns / 1e3 -
    baseTimeNanoseconds / 1e3``, so spans line up with the trace, and the
    spans of ranks on one host with each other.
  * Counters: :func:`count` adds to a named counter, and to the innermost
    open span's record. ``_build.launch`` counts each kernel launch under
    ``launch.<kernel>``; :func:`host_read` is the one way the program
    reads a tensor's values to the host, and counts ``host_reads``; the
    front end's copies (``api._rows``, ``api.copy_bits_``) count the device
    bytes they write as ``copy_bytes``, and ``api.decompress_into`` the
    members it decodes straight into their destinations as
    ``direct_members``.
  * ``read_trace(logdir)`` and ``stage_account(events)`` read a capture
    back and attribute its host and device time to the stages.

A ``record_function`` costs about 7 us of host time even when no profiler
records, an NVTX push and pop about 1 us, and the compress paths are
host-bound, so a span does nothing unless a profiler records or the
recorder is on: it then costs a flag check and its object.

Spans are host events around a call's launches: under a CUDA graph capture
they run once, at the capture, and a replay of the graph runs the kernels
without them.
"""

from __future__ import annotations

import atexit
import functools
import gzip
import itertools
import json
import os
import threading
import time
from collections import deque
from pathlib import Path

import torch

STAGE_PREFIX = "dietgpu."
OUTSIDE = "(outside the stages)"  # stage_account's row of unstaged device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_LIMIT = 65536  # the ring keeps the last this many spans
SPANS_DIR_ENV = "DIETGPU_SPANS_DIR"
HOST_READS = "host_reads"
COPY_BYTES = "copy_bytes"
DIRECT_MEMBERS = "direct_members"
SPAN_FIELDS = ("id", "name", "parent", "call", "start_ns", "end_ns", "thread", "profiler",
               "counts")

_active = None  # the running torch.profiler.profile, if any
_counts = {}  # counter name -> count since its reset
_ring = deque(maxlen=SPAN_LIMIT)
_ids = itertools.count(1)
_open_spans = threading.local()  # .stack: this thread's open recorded spans, innermost last
_recording = 0  # open record_spans() blocks, plus one while DIETGPU_SPANS_DIR is set
_EPOCH_NS, _PERF_NS = time.time_ns(), time.perf_counter_ns()


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
    """Span `name` (its profiler twin ``dietgpu.<name>``), entered with
    ``with``; it does nothing unless a profiler records or the recorder is
    on. `cuda` adds an NVTX range for tensors on the card (None: where a
    card is present); `call` gives the span's call id where it has no open
    parent (a collective's, the same on every rank)."""

    __slots__ = ("name", "stage", "cuda", "call", "_range", "_span")

    def __init__(self, name: str, cuda: bool | None = False, call=None):
        self.stage = name
        self.name = STAGE_PREFIX + name
        self.cuda = cuda
        self.call = call
        self._range = self._span = None

    def __enter__(self):
        prof = torch.autograd._profiler_enabled()
        if prof or _recording:
            self._span = _open(self.stage, self.call, prof)
            if prof:
                if self.cuda is None:
                    self.cuda = torch.cuda.is_available()
                if self.cuda:
                    torch.cuda.nvtx.range_push(self.name)
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            _close(self._span)
            self._span = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
            if self.cuda:
                torch.cuda.nvtx.range_pop()
        return False


def entry(name: str):
    """Decorator: each call of the function runs inside span `name`; a
    call from inside another entry's span is its child."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name, None):
                return fn(*args, **kwargs)

        return call

    return wrap


def _open(name, call, prof):
    stack = getattr(_open_spans, "stack", None)
    if stack is None:
        stack = _open_spans.stack = []
    sid = next(_ids)
    parent = stack[-1] if stack else None
    if parent is not None:
        call = parent[3]
    elif call is None:
        call = sid
    span = [sid, name, None if parent is None else parent[0], call, 0, 0,
            threading.get_ident(), prof, None]
    stack.append(span)
    span[4] = time.perf_counter_ns()
    return span


def _close(span):
    span[5] = time.perf_counter_ns()
    stack = _open_spans.stack
    if stack[-1] is span:
        stack.pop()
    else:  # closed out of order: a span left open by a generator or another frame
        stack.remove(span)
    _ring.append(tuple(span))


def _epoch_ns(perf_ns: int) -> int:
    return _EPOCH_NS + perf_ns - _PERF_NS


def spans() -> list:
    """The spans in the ring, in the order they ended, as dicts of
    :data:`SPAN_FIELDS`; start_ns and end_ns on the Unix epoch, counts
    {counter: increment} or None."""
    out = []
    for s in list(_ring):
        d = dict(zip(SPAN_FIELDS, s))
        d["start_ns"], d["end_ns"] = _epoch_ns(s[4]), _epoch_ns(s[5])
        out.append(d)
    return out


class record_spans:
    """``with record_spans() as rec:`` turns the recorder on for the block,
    with or without a profiler; ``rec.spans()`` gives the spans that
    started inside it and have ended."""

    def __enter__(self):
        global _recording
        self._first, self._last = next(_ids), None
        _recording += 1
        return self

    def __exit__(self, *exc):
        global _recording
        _recording -= 1
        self._last = next(_ids)
        return False

    def spans(self) -> list:
        return [s for s in spans()
                if s["id"] > self._first and (self._last is None or s["id"] < self._last)]


def _write_spans(directory: str) -> None:
    """The ring's spans as JSON lines, one a span, into
    ``<directory>/spans.<pid>.jsonl``."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"spans.{os.getpid()}.jsonl"), "w") as f:
        for s in spans():
            f.write(json.dumps(s) + "\n")


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`, and to the record of this thread's
    innermost open span."""
    _counts[name] = _counts.get(name, 0) + n
    stack = getattr(_open_spans, "stack", None)
    if stack:
        span = stack[-1]
        if span[8] is None:
            span[8] = {}
        span[8][name] = span[8].get(name, 0) + n


def counter(name: str) -> int:
    """Counter `name` since its last reset."""
    return _counts.get(name, 0)


def reset_counters(names) -> None:
    for name in names:
        _counts.pop(name, None)


def host_read(t: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """`t` on the host (`t` itself on the CPU): the one way the program
    reads a tensor's values, counted as one ``host_reads``. It counts on
    the CPU too, so that a CPU run counts the reads the card's route makes;
    `plain` marks a read of a kernel's plain version, which stands for a
    kernel that reads nothing back, and counts only on the card (where the
    plain version runs as the kernels' reference). Opens no span."""
    if not plain or t.device.type != "cpu":
        count(HOST_READS)
    return t.cpu()


if os.environ.get(SPANS_DIR_ENV):
    _recording += 1
    atexit.register(_write_spans, os.environ[SPANS_DIR_ENV])


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
