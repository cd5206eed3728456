"""The port's profiler capture and stage ranges
(``dietgpu_tpu_torch.profiling``) on the CPU, and one case on the card.

The stage names are the JAX package's, letter for letter: they are read
with ``ast`` from its ``annotate`` calls and must equal the set that CPU
profiles of the port's entry points show. Each entry point's profile must
show every stage its path reaches, nested as in the JAX package, and the
capture must raise where ``jax.profiler`` does.
"""

import ast
import os

import numpy as np
import pytest
import torch

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import profiling
from dietgpu_tpu_torch.profiling import OUTSIDE, read_trace, stage_account
from torch_port_helpers import cuda_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_STAGED = ("dietgpu_tpu/floatcodec/pallas_codec.py", "dietgpu_tpu/ans/pallas_encode.py")
BF16, F32 = 2, 3
LW = 3 * 4096

FLOAT = {"float.split", "float.stats", "float.ans_encode"}
ANS = {"ans.encode_kernel", "ans.sections", "ans.assembly"}
ANS_BATCHED = {n + "_batched" for n in ANS}


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
        "raw encode": (lambda: port.ans_encode_padded(raw, n, 10, True), ANS),
        "raw batched encode": (lambda: port.ans_encode_batched(torch.stack([raw, raw]), [n, 3]),
                               ANS_BATCHED),
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
    seen = set()
    for path, (call, _) in _paths().items():
        rows, _ = stage_account(_profile(tmp_path / path.replace(" ", "_"), call))
        seen |= set(rows) - {OUTSIDE}
    assert seen == jax_names


@pytest.mark.parametrize("path", [
    "bf16 compress", "f32 compress", "bf16 decompress", "f32 decompress",
    "batched bf16 compress", "batched f32 decompress", "batched bf16 decompress",
    "raw encode", "raw batched encode"])
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
    with profiling.trace_annotation("x") as r:
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
