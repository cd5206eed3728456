"""The harness: its files and names, BENCHMARK.json against them, a cell,
configuration, mix and metric added as new files alone, the reference
against the program's CPU route, the seeds, and the trace reduction."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import cells, inputs, trace, work
from portbench.drivers import allgather
from portbench.reference import floatref

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "portbench"


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_file_name_is_a_name():
    for sub in ("configs", "workloads", "traffic", "metrics"):
        for path in (PB / sub).iterdir():
            if path.name == "__pycache__":
                continue
            cells.check_name(path.stem, sub)
    for mod in cells.readers().values():
        cells.check_unit(mod.UNIT)


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "-a", "é", "x" * 65])
def test_bad_names_are_refused(bad):
    with pytest.raises(ValueError):
        cells.check_name(bad, "name")


@pytest.mark.parametrize("bad", ["", "tokens per s", "x" * 17, "µs"])
def test_bad_units_are_refused(bad):
    with pytest.raises(ValueError):
        cells.check_unit(bad)


def test_benchmark_json_matches_the_files():
    b = _bench()
    assert b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    units = {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}
    readers = cells.readers()
    for w in b["workloads"]:
        cell = cells.load_cell(w["name"])
        spec = json.loads((PB / "workloads" / f"{w['name']}.json").read_text())
        assert (spec["config"], spec["traffic"], spec["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert w["config"] in names and cell.driver()
    for m in b["per_layer"]:
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
        for cell in m["workloads"]:
            moves = [e for e in b["end_to_end"] if e["name"] == m["moves"]][0]
            assert cell in moves.get("workloads", [w["name"] for w in b["workloads"]])
    for name, unit in units.items():
        cells.check_name(name, "metric")
        cells.check_unit(unit)


def _tree_hashes(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_mix_and_metric_are_new_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell and a
    per-layer reader as new files; the new cell runs, the new metric is
    read, and no file that was there changed."""
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_hashes(tmp_path / "portbench")
    new = tmp_path / "portbench"
    (new / "configs" / "tiny-f16.json").write_text(json.dumps({
        "name": "tiny-f16", "source": "a test", "dtype": "float16",
        "init": {"kind": "normal", "mean": 0.0, "std": 2.0}, "prob_bits": 9,
        "checksum": False, "reduced": [], "assumed": {}}))
    (new / "traffic" / "api-16Ki-x3.json").write_text(json.dumps({
        "driver": "codec", "entry": "torch_api", "words": 16384, "pool": 3,
        "trace_seconds": 0.2}))
    (new / "workloads" / "f16-16Ki.eager.json").write_text(json.dumps({
        "config": "tiny-f16", "traffic": "api-16Ki-x3", "chips": 1}))
    (new / "metrics" / "calls.compress.py").write_text(
        'UNIT = "calls"\n\n\ndef read(ctx):\n'
        '    h = ctx.get("halves", {}).get("api_compress")\n'
        '    return None if h is None else h["calls"]\n')
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{REPO}"}
    lines = []
    for traced in ("0", "1"):
        out = subprocess.run(
            [sys.executable, "-m", "portbench.tests.cpu_run", "--workload", "f16-16Ki.eager",
             "--seed", str(2**33 + 7), "--seconds", "0.5", "--trace", traced],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        lines.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert lines[0]["correct"] and lines[1]["correct"]
    assert set(lines[0]["metrics"]) == {"api_compress_GBps", "api_decompress_GBps", "setup_s"}
    assert lines[1]["metrics"]["calls.compress"]["value"] >= 3
    after = _tree_hashes(new)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("float_type,dtype", [(floatref.FLOAT16, torch.float16),
                                              (floatref.BFLOAT16, torch.bfloat16),
                                              (floatref.FLOAT32, torch.float32)])
@pytest.mark.parametrize("n", [1, 100, 4096, 3 * 4096 + 17])
def test_the_reference_writes_the_programs_archive(float_type, dtype, n):
    """On the CPU, where both are plain torch, the reference's archive is
    the port's, byte for byte."""
    import dietgpu_tpu_torch as port

    x = inputs.normal(n, dtype, 0.0, 1.0, torch.device("cpu"), 5, n)
    w = inputs.words(x)
    Lw = floatref.round_up(n, floatref.BLOCK)
    padded = torch.zeros(Lw, dtype=w.dtype)
    padded[:n] = w
    arc, size = port.float_compress_padded(padded, n, float_type, 10)
    ref = floatref.float_archive(w, float_type, 10)
    assert int(size) == ref.numel()
    assert torch.equal(arc.view(torch.uint8)[: int(size)], ref)


def test_the_reference_encodes_in_blocks_as_in_one(monkeypatch):
    x = inputs.normal(5 * 4096 + 9, torch.bfloat16, 0.0, 1.0, torch.device("cpu"), 9)
    whole = floatref.float_archive(inputs.words(x), floatref.BFLOAT16, 11)
    monkeypatch.setattr(floatref, "CHUNK_BLOCKS", 2)
    assert torch.equal(floatref.float_archive(inputs.words(x), floatref.BFLOAT16, 11), whole)


def test_seeds_are_large_and_repeat():
    big = 2**31 + 12345
    assert inputs.sub_seed(big, 0) == inputs.sub_seed(big, 0)
    assert inputs.sub_seed(big, 0) != inputs.sub_seed(big, 1)
    assert inputs.sub_seed(big, 0) != inputs.sub_seed(big + 1, 0)
    dev = torch.device("cpu")
    a = inputs.normal(1000, torch.bfloat16, 0, 1, dev, big, 3)
    assert torch.equal(a, inputs.normal(1000, torch.bfloat16, 0, 1, dev, big, 3))


def test_the_falcon_layer_cuts_into_the_published_shards():
    cfg = cells.load_cell("allgather-falcon40b-layer.4chip").config
    assert sum(n for _, n, _ in allgather.layer_params(cfg)) == cfg["layer_words"] == 679510016
    assert allgather.shard_words(cfg, 4) == 169877504
    tiny = {**cfg, "layer": [["w", [4, 10], "normal"], ["ln.weight", [8], "ones"],
                             ["ln.bias", [8], "zeros"]]}
    dev = torch.device("cpu")
    full = torch.cat([allgather.make_shard(tiny, 0, r, 4, dev, 7) for r in range(4)])
    assert torch.equal(full[40:48], torch.ones(8, dtype=full.dtype))
    assert torch.equal(full[48:], torch.zeros(8, dtype=full.dtype))


def test_bytes_are_counted_from_shapes():
    assert work.compress_bytes(100, 60) == work.decompress_bytes(100, 60) == 160
    assert work.allgather_codec_bytes(10, 6, [6, 7, 6, 5]) == 10 + 6 + 24 + 40
    assert work.least_seconds(3.35e12) == pytest.approx(1.0)


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_a_trace_reduces_to_busy_time_gaps_and_ops():
    label = trace.WINDOW_PREFIX + "w"
    events = [
        _x(label, "user_annotation", 0, 100),
        _x("dietgpu.float.stats", "user_annotation", 5, 30),
        _x("aten::add", "cpu_op", 6, 10), _x("aten::empty", "cpu_op", 7, 1),
        _x("aten::mul", "cpu_op", 40, 5),
        _x("k1", "kernel", 10, 20), _x("k2", "kernel", 25, 15),
        _x("ncclKernel_AllGather", "kernel", 60, 10), _x("late", "kernel", 95, 20),
        _x("cudaDeviceSynchronize", "cuda_runtime", 70, 30),
    ]
    s = trace.reduce_events(events, label)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert s["device_s"] == pytest.approx((20 + 15 + 10 + 5) * 1e-6)
    assert s["nccl_s"] == pytest.approx(10e-6)
    assert s["top_level_aten_ops"] == 2
    assert s["stage_ranges"] == 1 and s["glue_s"] == pytest.approx(30e-6)
    assert s["idle_gaps"]["dietgpu.float.stats"] == pytest.approx(10e-6)
    assert s["idle_gaps"]["cudaDeviceSynchronize"] == pytest.approx(25e-6)
    assert sum(s["idle_gaps"].values()) == pytest.approx(s["window_s"] - s["busy_s"])
    assert trace.top({"a": 1.0, "b": 3.0}, 1) == [["b", 3.0]]
    assert np.isclose(trace.merge([s, s])["busy_s"], 2 * s["busy_s"])
