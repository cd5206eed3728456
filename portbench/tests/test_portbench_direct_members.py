"""The reader of ``front.direct_members.api_decompress`` on a traced run of
the FP8 expert cell at a small size on the CPU: every member of a call is
decoded straight into its destination; and nothing is read where the
program has no such counter."""

import time

import torch

from portbench import cells
from portbench.drivers import experts
from portbench.tests.small import small_cell

CELL = "dsv3-experts-fp8.eager"
NAME = "front.direct_members.api_decompress"


def test_the_reader_counts_the_members_of_a_call(monkeypatch):
    cell = small_cell(CELL)
    out = experts.run(cell, 2147483990, 0.4, True, "portbench.sut:program",
                      torch.device("cpu"), time.perf_counter())
    ctx = out["trace"]["ctx"]
    got = cells.read_metrics(ctx)
    assert got[NAME]["value"] == len(cell.config["layer"])
    assert got[NAME]["unit"] == "members/call"

    from dietgpu_tpu_torch import profiling

    monkeypatch.delattr(profiling, "DIRECT_MEMBERS")
    assert NAME not in cells.read_metrics(ctx)
