"""The port's profiler capture, stage ranges, span recorder and counters
(``dietgpu_tpu_torch.profiling``) on the CPU, and one case on the card.

The stage names are the JAX package's, letter for letter: they are read
with ``ast`` from its ``annotate`` calls and, with the port's two spans of
the byte path that the JAX package leaves unlabelled (its histogram pass
and its raw decode), must equal the set that CPU profiles of the port's
entry points show. Each entry point's profile must
show every stage its path reaches, nested as in the JAX package, and the
capture must raise where ``jax.profiler`` does. The recorder keeps nothing
while it is off, keeps the front end's call as one tree of spans with its
host reads, holds its ring's bound, lines its spans up with a CPU profile's
clock, and writes one file a process under ``DIETGPU_SPANS_DIR``.
"""

import ast
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import _build, api, profiling, torch_api
from dietgpu_tpu_torch.profiling import OUTSIDE, read_trace, stage_account
from torch_port_helpers import cuda_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_STAGED = ("dietgpu_tpu/floatcodec/pallas_codec.py", "dietgpu_tpu/ans/pallas_encode.py")
BF16, F32 = 2, 3
LW = 3 * 4096

FLOAT = {"float.split", "float.stats", "float.ans_encode"}
ANS = {"ans.encode_kernel", "ans.sections", "ans.assembly"}
ANS_BATCHED = {n + "_batched" for n in ANS}
PORT_ONLY = {"ans.hist", "ans.decode"}  # the byte path's, unlabelled in the JAX package


def _jax_stage_names() -> set:
    names = set()
    for rel in JAX_STAGED:
        with open(os.path.join(REPO, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "annotate"):
                names.add(node.args[0].value)
    return names


def _inputs():
    rng = np.random.default_rng(0x5EED)
    x = torch.from_numpy(rng.standard_normal(LW).astype(np.float32))
    bf16 = (x.view(torch.int32) >> 16).to(torch.int16)
    raw = torch.from_numpy(np.minimum(rng.exponential(30, LW), 255).astype(np.uint8))
    return x.view(torch.int32), bf16, raw


def _paths():
    """path -> (call, the stages it must show)."""
    f32, bf16, raw = _inputs()
    n = LW - 5
    arc16, _ = port.float_compress_padded(bf16, n, BF16)
    arc32, _ = port.float_compress_padded(f32, n, F32)
    arcs16, _ = port.float_compress_batched(torch.stack([bf16, bf16]), n, BF16)
    arcs32, _ = port.float_compress_batched(torch.stack([f32, f32]), n, F32)
    arc_raw, _ = port.ans_encode_padded(raw, n)
    arcs_raw, _ = port.ans_encode_batched(torch.stack([raw, raw]), [n, 3])
    return {
        "bf16 compress": (lambda: port.float_compress_padded(bf16, n, BF16), FLOAT | ANS),
        "f32 compress": (lambda: port.float_compress_padded(f32, n, F32, 10, True), FLOAT | ANS),
        "bf16 decompress": (lambda: port.float_decompress_padded(arc16, BF16, LW),
                            {"float.fused_decode_join"}),
        "f32 decompress": (lambda: port.float_decompress_padded(arc32, F32, LW),
                           {"float.fused_decode_join_f32"}),
        "batched bf16 compress": (
            lambda: port.float_compress_batched(torch.stack([bf16, bf16]), [n, 7], BF16),
            FLOAT | ANS_BATCHED),
        "batched f32 decompress": (lambda: port.float_decompress_batched(arcs32, F32, LW),
                                   {"float.fused_decode_join_f32"}),
        "batched bf16 decompress": (lambda: port.float_decompress_batched(arcs16, BF16, LW),
                                    {"float.fused_decode_join"}),
        "raw encode": (lambda: port.ans_encode_padded(raw, n, 10, True), ANS | {"ans.hist"}),
        "raw batched encode": (lambda: port.ans_encode_batched(torch.stack([raw, raw]), [n, 3]),
                               ANS_BATCHED | {"ans.hist"}),
        "raw decode": (lambda: port.ans_decode_padded(arc_raw, 10, LW), {"ans.decode"}),
        "raw batched decode": (lambda: port.ans_decode_batched(arcs_raw, 10, LW),
                               {"ans.decode"}),
    }


def _profile(tmp_path, fn):
    logdir = tmp_path / "trace"
    profiling.profiler_start(str(logdir))
    try:
        fn()
    finally:
        profiling.profiler_stop()
    return read_trace(logdir)


def test_stage_names_equal_the_jax_packages(tmp_path):
    jax_names = _jax_stage_names()
    assert len(jax_names) == 11, jax_names
    assert not jax_names & PORT_ONLY
    seen = set()
    for path, (call, _) in _paths().items():
        rows, _ = stage_account(_profile(tmp_path / path.replace(" ", "_"), call))
        seen |= set(rows) - {OUTSIDE}
    assert seen == jax_names | PORT_ONLY


@pytest.mark.parametrize("path", [
    "bf16 compress", "f32 compress", "bf16 decompress", "f32 decompress",
    "batched bf16 compress", "batched f32 decompress", "batched bf16 decompress",
    "raw encode", "raw batched encode", "raw decode", "raw batched decode"])
def test_profile_shows_each_stage_of_the_path(tmp_path, path):
    call, want = _paths()[path]
    events = _profile(tmp_path, call)
    rows, _ = stage_account(events)
    assert set(rows) - {OUTSIDE} == want
    assert all(rows[s]["calls"] == 1 for s in want)
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    if "float.ans_encode" in want:  # the ANS stages run inside it, as in the JAX package
        outer = spans["dietgpu.float.ans_encode"]
        for s in want - FLOAT:
            inner = spans["dietgpu." + s]
            assert outer["ts"] <= inner["ts"]
            assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert rows["float.ans_encode"]["host_self_ms"] < rows["float.ans_encode"]["host_ms"]


def test_ranges_cost_nothing_without_a_profiler():
    """Outside a capture a range enters no record_function."""
    with profiling.annotate("float.split") as r:
        assert r._range is None
        assert r.name == "dietgpu.float.split"
    with profiling.annotate("x") as r:
        assert r._range is None


def test_nvtx_ranges_only_inside_a_capture(tmp_path, monkeypatch):
    """A range for card tensors pushes an NVTX range only while a profiler
    records: outside a capture it costs the host a flag check."""
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append(("pop",)))
    with profiling.annotate("ans.sections", cuda=True):
        pass
    assert calls == []
    profiling.profiler_start(str(tmp_path / "trace"))
    try:
        with profiling.annotate("ans.sections", cuda=True):
            assert calls == [("push", "dietgpu.ans.sections")]
        with profiling.annotate("ans.assembly"):
            pass
    finally:
        profiling.profiler_stop()
    assert calls == [("push", "dietgpu.ans.sections"), ("pop",)]


@pytest.mark.gpu
def test_emit_nvtx_turns_the_ranges_on(cuda_device):
    """Under Nsight Systems' ``emit_nvtx`` the ranges record, NVTX included."""
    with profiling.annotate("float.split", cuda=True) as r:
        assert r._range is None
    with torch.autograd.profiler.emit_nvtx():
        with profiling.annotate("float.split", cuda=True) as r:
            assert r._range is not None
        words = torch.zeros(3 * 4096, dtype=torch.int16, device=cuda_device)
        port.float_compress_padded(words, 5000, BF16)


def test_double_start_and_stop_without_start_raise(tmp_path):
    with pytest.raises(RuntimeError, match="no profile"):
        profiling.profiler_stop()
    profiling.profiler_start(str(tmp_path / "a"))
    try:
        with pytest.raises(RuntimeError, match="already"):
            profiling.profiler_start(str(tmp_path / "b"))
    finally:
        profiling.profiler_stop()
    with pytest.raises(RuntimeError, match="no profile"):
        profiling.profiler_stop()
    assert len(read_trace(tmp_path / "a")) > 0
    assert not (tmp_path / "b").exists()


# ---- the span recorder and the counters ----

GLUE = ("float.", "ans.")


def _bf16(n=LW - 6, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)


def _last_span():
    return profiling._ring[-1] if profiling._ring else None


def test_nothing_is_recorded_with_the_recorder_off():
    x = _bf16()
    out = torch.empty_like(x)
    before, last = len(profiling._ring), _last_span()
    comp, _, _ = torch_api.compress_data(True, [x])
    torch_api.decompress_data(True, [comp[0]], [out])
    with profiling.annotate("float.split") as r:
        assert r._span is None
    assert len(profiling._ring) == before and _last_span() is last
    assert not getattr(profiling._open_spans, "stack", [])


def _tree(spans):
    """{call: [spans]}, and each span's children."""
    calls, children = {}, {}
    for s in spans:
        calls.setdefault(s["call"], []).append(s)
        children.setdefault(s["parent"], []).append(s)
    return calls, children


def _length(s):
    return s["end_ns"] - s["start_ns"]


def test_the_front_ends_call_is_one_tree_of_spans():
    """compress_data and decompress_data: each a root front.* span, the
    api entry its child, then float.*, then ans.*; one call id a call; the
    self times of a call's spans add up to its root's length, and so do the
    front end's self time and the glue's."""
    x = _bf16()
    out = torch.empty_like(x)
    with profiling.record_spans() as rec:
        comp, _, _ = torch_api.compress_data(True, [x])
        torch_api.decompress_data(True, [comp[0]], [out])
    assert torch.equal(out.view(torch.int16), x.view(torch.int16))
    spans = rec.spans()
    calls, children = _tree(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["front.compress", "front.decompress"]
    assert [r["call"] for r in roots] == [r["id"] for r in roots]
    assert set(calls) == {r["id"] for r in roots}
    by_id = {s["id"]: s for s in spans}
    want = {
        "front.compress": {"front.compress": "front.compress", "float.split": "front.compress",
                           "float.stats": "front.compress", "float.ans_encode": "front.compress",
                           "ans.encode_kernel_batched": "float.ans_encode",
                           "ans.sections_batched": "float.ans_encode",
                           "ans.assembly_batched": "float.ans_encode"},
        "front.decompress": {"front.decompress": "front.decompress",
                             "float.fused_decode_join": "front.decompress"},
    }
    for root in roots:
        mine = [s for s in calls[root["id"]] if s is not root]
        assert {s["name"]: by_id[s["parent"]]["name"] for s in mine} == want[root["name"]]
        assert all(s["thread"] == root["thread"] and not s["profiler"] for s in mine)
        for s in calls[root["id"]]:
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
        selfs = [_length(s) - sum(_length(c) for c in children.get(s["id"], []))
                 for s in calls[root["id"]]]
        assert min(selfs) >= 0 and sum(selfs) == _length(root)
        front_self = sum(v for s, v in zip(calls[root["id"]], selfs)
                         if s["name"].startswith("front."))
        glue_top = [s for s in mine if s["name"].startswith(GLUE)
                    and by_id[s["parent"]]["name"].startswith("front.")]
        assert front_self + sum(_length(s) for s in glue_top) == _length(root)


def test_the_ring_holds_its_bound():
    with profiling.record_spans() as rec:
        for _ in range(profiling.SPAN_LIMIT + 10):
            with profiling.annotate("x"):
                pass
        with profiling.annotate("last"):
            pass
    assert len(profiling._ring) == profiling.SPAN_LIMIT
    got = rec.spans()
    assert len(got) == profiling.SPAN_LIMIT and got[-1]["name"] == "last"
    assert [s["id"] for s in got] == sorted(s["id"] for s in got)


def _reads(fn):
    before = profiling.counter(profiling.HOST_READS)
    fn()
    return profiling.counter(profiling.HOST_READS) - before


def _read_cases():
    x, y = _bf16(), _bf16(5000, 2)
    flat = torch.cat([x, y])
    words = torch.zeros(LW, dtype=torch.int16)
    words[: x.numel()] = x.view(torch.int16)
    arc, _ = port.float_compress_padded(words, x.numel(), BF16)
    comp, _, _ = torch_api.compress_data(True, [x, y])
    outs = [torch.empty_like(x), torch.empty_like(y)]
    return {
        "api.compress_data": (lambda: api.compress_data(True, [x, y]), 0),
        "api.compress_data_split_size": (
            lambda: api.compress_data_split_size(True, flat, [x.numel(), y.numel()]), 0),
        "api.compress_data_stride": (lambda: api.compress_data_stride(True, flat.view(2, -1)), 0),
        "torch_api.compress_data": (lambda: torch_api.compress_data(True, [x, y]), 0),
        "torch_api.compress_data_split_size": (
            lambda: torch_api.compress_data_split_size(True, flat, [x.numel(), y.numel()]), 0),
        "float_compress_padded": (lambda: port.float_compress_padded(words, x.numel(), BF16), 0),
        "float_decompress_padded": (lambda: port.float_decompress_padded(arc, BF16, LW), 0),
        # the _simple tier reads its sizes once, as the reference's does
        "api.compress_data_simple": (lambda: api.compress_data_simple(True, [x, y]), 1),
        "torch_api.compress_data_simple": (lambda: torch_api.compress_data_simple(True, [x]), 1),
        # decoded straight into outs: the status stays on the device
        "torch_api.decompress_data": (
            lambda: torch_api.decompress_data(True, [comp[0], comp[1]], outs), 0),
        # a checksum call goes through a buffer: the checksum's verdict, then
        # the status that chooses the members to copy out
        "torch_api.decompress_data.checksum": (
            lambda: torch_api.decompress_data(True, [comp[0], comp[1]], outs, True), 2),
    }


@pytest.mark.parametrize("case", [
    "api.compress_data", "api.compress_data_split_size", "api.compress_data_stride",
    "torch_api.compress_data", "torch_api.compress_data_split_size", "float_compress_padded",
    "float_decompress_padded", "api.compress_data_simple", "torch_api.compress_data_simple",
    "torch_api.decompress_data", "torch_api.decompress_data.checksum"])
def test_host_reads_of_each_entry_point(case):
    """Host reads a call makes, counted on the CPU as the card's route makes
    them (the plain decode's header reads stand for the kernel's, which make
    none); the reads of a call also land in its spans' counts."""
    fn, want = _read_cases()[case]
    assert _reads(fn) == want
    with profiling.record_spans() as rec:
        fn()
    assert sum((s["counts"] or {}).get(profiling.HOST_READS, 0) for s in rec.spans()) == want


def test_launches_count_in_the_registry():
    _build.reset_kernel_launches()
    with profiling.record_spans() as rec:
        with profiling.annotate("x"):
            profiling.count("launch.split")
            profiling.count("launch.split")
    assert _build.kernel_launches() == dict.fromkeys(_build.KERNELS, 0) | {"split": 2}
    assert rec.spans()[0]["counts"] == {"launch.split": 2}
    _build.reset_kernel_launches()
    assert not any(_build.kernel_launches().values())


def test_spans_line_up_with_a_cpu_profiles_clock(tmp_path):
    """A span's start, on the epoch, is its twin's ``ts`` after taking the
    trace's baseTimeNanoseconds, within 50 us at the median."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(200):
            with profiling.annotate("x.outer"):
                with profiling.annotate("x.inner"):
                    torch.zeros(16).add_(1)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"]
    recorded = [s for s in profiling.spans() if s["profiler"]]
    for name in ("x.outer", "x.inner"):
        twins = sorted((e for e in trace["traceEvents"] if e.get("name") == "dietgpu." + name),
                       key=lambda e: e["ts"])
        mine = sorted((s for s in recorded if s["name"] == name),
                      key=lambda s: s["start_ns"])[-200:]
        assert len(twins) == len(mine) == 200
        gaps = [e["ts"] - (s["start_ns"] - base) / 1e3 for e, s in zip(twins, mine)]
        assert abs(statistics.median(gaps)) < 50, statistics.median(gaps)


def test_the_spans_dir_gets_one_file_a_process(tmp_path):
    code = (
        "import torch\n"
        "from dietgpu_tpu_torch import torch_api\n"
        "x = torch.ones(5000, dtype=torch.bfloat16)\n"
        "torch_api.compress_data(True, [x])\n"
        "import os; print(os.getpid())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, DIETGPU_SPANS_DIR=str(tmp_path / "spans"))
    pids = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, cwd=REPO, timeout=120)
        assert out.returncode == 0, out.stderr
        pids.append(int(out.stdout.split()[-1]))
    files = sorted(p.name for p in (tmp_path / "spans").iterdir())
    assert files == sorted(f"spans.{pid}.jsonl" for pid in pids)
    for name in files:
        lines = [json.loads(x) for x in (tmp_path / "spans" / name).read_text().splitlines()]
        assert all(list(s) == list(profiling.SPAN_FIELDS) for s in lines)
        roots = [s for s in lines if s["parent"] is None]
        assert [r["name"] for r in roots] == ["front.compress"]
        assert len(lines) == 8 and {s["call"] for s in lines} == {roots[0]["id"]}
