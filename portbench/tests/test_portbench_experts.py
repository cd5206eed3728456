"""The FP8 expert cell at a small size on the CPU: its configuration at
DeepSeek-V3's published widths, a run through the port's CPU route that
comes out correct, each fault and the control that it has to fail, and its
five per-layer readers on a traced run."""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import cells
from portbench.drivers import experts
from portbench.tests.small import small_cell, spec_json

REPO = Path(__file__).resolve().parents[2]
CELL = "dsv3-experts-fp8.eager"
NEW = ("ans.hist_roofline.api_compress", "ans.decode_raw_roofline.api_decompress",
       "front.copy_mb.api_compress", "front.copy_mb.api_decompress",
       "glue.idle_ms.api_decompress")


def _cpu_run(sut="portbench.sut:program", trace=0):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.tests.cpu_run", "--cell", spec_json(small_cell(CELL)),
         "--seed", "2147483999", "--seconds", "0.4", "--trace", str(trace), "--sut", sut],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_configuration_is_one_ep32_ranks_share_of_a_layer():
    cfg = cells.load_cell(CELL).config
    shapes = [shape for _, shape, _ in cfg["layer"]]
    assert len(shapes) == 3 * cfg["n_routed_experts"] == 24
    h, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    assert shapes == [[f, h], [f, h], [h, f]] * 8
    assert sum(a * b for a, b in shapes) == 352321536  # bytes, one a value
    assert cfg["model"]["n_layer"] <= cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    assert cfg["dtype"] == "float8_e4m3fn" and cfg["block"] == [128, 128]
    assert set(cfg["reduced"]) == {"n_routed_experts", "n_layer"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_small_cell_runs_correct(trace):
    line = _cpu_run(trace=trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 6
    assert all(c["value"] == 0 == c["limit"] for c in line["checks"].values())
    if not trace:
        assert set(line["metrics"]) == {"api_compress_GBps", "api_decompress_GBps", "setup_s"}


@pytest.mark.parametrize("sut", ["portbench.tests.faults:altered", "portbench.tests.faults:half",
                                 "portbench.reference.control_fp8:lower_precision"])
def test_the_check_fails_a_broken_timed_path(sut):
    line = _cpu_run(sut)
    assert line["correct"] is False and line["failed"] > 0
    assert line["checks"]["archive_bytes_wrong"]["value"] > 0
    assert line["checks"]["decoded_bytes_wrong"]["value"] > 0


def test_the_new_readers_read_a_traced_run():
    """The span readers read the run's own spans and gaps. The CPU runs no
    kernel, so the two kernel readers are given the device times that the
    card's trace names, beside the least times the run counted."""
    cell = small_cell(CELL)
    out = experts.run(cell, 2147483999, 0.4, True, "portbench.sut:program",
                      torch.device("cpu"), time.perf_counter())
    ctx = out["trace"]["ctx"]
    got = cells.read_metrics(ctx)
    assert got["front.copy_mb.api_compress"]["value"] > 0
    assert got["front.copy_mb.api_decompress"]["value"] > 0
    # the CPU runs nothing on a device: the half is one gap, labelled by
    # what the host did at its middle
    assert got["glue.idle_ms.api_decompress"]["value"] >= 0
    comp, dec = ctx["halves"]["api_compress"], ctx["halves"]["api_decompress"]
    assert comp["least_s"] > comp["hist_least_s"] > 0
    assert 0 < dec["decode_raw_least_s"] == dec["least_s"]
    assert not set(NEW[:2]) & set(got)  # no kernel ran
    comp["device_ops"] = {"void (anonymous namespace)::hist_kernel(unsigned int const*)": 0.5,
                          "(anonymous namespace)::encode_kernel(unsigned char const*)": 9.0}
    dec["device_ops"] = {"void (anonymous namespace)::decode_kernel<2>(unsigned int const*)": 0.5,
                         "void (anonymous namespace)::decode_kernel<0>(unsigned int const*)": 9.0}
    got = cells.read_metrics(ctx)
    assert got[NEW[0]]["value"] == pytest.approx(200.0 * comp["hist_least_s"])
    assert got[NEW[1]]["value"] == pytest.approx(200.0 * dec["decode_raw_least_s"])
    # a small layer's copies: the compress's zero fill and member copies
    members = sum(math.prod(shape) for _, shape, _ in cell.config["layer"])
    assert got["front.copy_mb.api_compress"]["value"] > members / 1e6
