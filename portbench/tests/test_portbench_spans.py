"""The readers of the program's spans and of the idle gaps they label, on
hand-made contexts and spans: their numbers, and nothing where the program
records no spans, the roots are not one per traced call, or the cell is
another's."""

import pytest

from dietgpu_tpu_torch import profiling
from portbench import cells, spans

MS = 1_000_000  # ns


def _span(sid, name, parent, call, start, end, profiler=True, counts=None):
    return {"id": sid, "name": name, "parent": parent, "call": call, "start_ns": start,
            "end_ns": end, "thread": 1, "profiler": profiler, "counts": counts}


def _compress_call(first, t0):
    """A traced compress call of 10 ms: the front end's own 4 ms around 6 ms
    of glue, float.ans_encode holding the ans.* spans."""
    r, a, s, st, e, k, q = range(first, first + 7)
    return [
        _span(s, "float.split", a, r, t0 + 1 * MS, t0 + 2 * MS),
        _span(st, "float.stats", a, r, t0 + 2 * MS, t0 + 4 * MS),
        _span(k, "ans.encode_kernel_batched", e, r, t0 + 4 * MS, t0 + 5 * MS),
        _span(q, "ans.sections_batched", e, r, t0 + 5 * MS, t0 + 6 * MS),
        _span(e, "float.ans_encode", a, r, t0 + 4 * MS, t0 + 7 * MS),
        _span(a, "front.compress", r, r, t0 + 0.5 * MS, t0 + 9 * MS),
        _span(r, "front.compress", None, r, t0, t0 + 10 * MS),
    ]


def _decompress_call(first, t0, reads=1):
    r, m, d = range(first, first + 3)
    return [
        _span(d, "float.fused_decode_join", m, r, t0 + 1 * MS, t0 + 2 * MS),
        _span(m, "front.decompress", r, r, t0 + 0.5 * MS, t0 + 3 * MS),
        _span(r, "front.decompress", None, r, t0, t0 + 4 * MS,
              counts={profiling.HOST_READS: reads}),
    ]


def _eager_run():
    """Two compress and two decompress calls traced, after two untraced
    warm-up calls."""
    warm = [dict(s, profiler=False) for s in _compress_call(1, 0) + _decompress_call(8, 0)]
    return (warm + _compress_call(11, 100 * MS) + _compress_call(21, 200 * MS)
            + _decompress_call(31, 300 * MS) + _decompress_call(41, 400 * MS, reads=3))


def _eager_ctx(comp_calls=2, dec_calls=2):
    gaps_c = {"dietgpu.front.compress": 0.004, "dietgpu.float.stats": 0.010,
              "dietgpu.ans.sections_batched": 0.006, "(python)": 0.001}
    gaps_d = {"dietgpu.front.decompress": 0.002, "aten::copy_": 0.001}
    rest = {"window_s": 1.0, "busy_s": 0.5, "device_s": 0.5, "least_s": 0.1,
            "stage_ranges": 20, "glue_s": 0.01, "top_level_aten_ops": 400}
    return {"cell": "bf16-512Mi.eager", "halves": {
        "api_compress": {"calls": comp_calls, "idle_gaps": gaps_c, **rest},
        "api_decompress": {"calls": dec_calls, "idle_gaps": gaps_d, **rest}}}


NEW = ("front.host_ms.api_compress", "front.host_ms.api_decompress",
       "front.host_reads.api_decompress", "front.idle_ms.api_compress",
       "front.idle_ms.api_decompress", "glue.idle_ms.api_compress")


@pytest.fixture
def recorded(monkeypatch):
    """Put `spans` in the program's recorder."""
    def put(got):
        monkeypatch.setattr(profiling, "spans", lambda: list(got))
    return put


def test_the_eager_readers_read_the_traced_calls(recorded):
    recorded(_eager_run())
    got = cells.read_metrics(_eager_ctx())
    want = {
        "front.host_ms.api_compress": 4.0,  # 10 ms less the glue's 6
        "front.host_ms.api_decompress": 3.0,  # 4 ms less the decode's 1
        "front.host_reads.api_decompress": 2.0,  # (1 + 3) / 2
        "front.idle_ms.api_compress": 2.0,  # 4 ms of gaps / 2 calls
        "front.idle_ms.api_decompress": 1.0,
        "glue.idle_ms.api_compress": 8.0,  # (10 + 6) / 2
    }
    assert {k: got[k]["value"] for k in NEW} == pytest.approx(want)
    assert got["front.host_reads.api_decompress"]["unit"] == "reads/call"


def test_front_time_and_glue_add_up_to_each_call():
    run = _compress_call(1, 0)
    root = run[-1]
    glue = spans.union_ns([s for s in run if s["name"].startswith(spans.GLUE)])
    assert spans.front_ns(root, run) + glue == root["end_ns"] - root["start_ns"]
    assert glue == 6 * MS  # split, stats, then ans_encode holding the ans.* spans: 1-7 ms


@pytest.mark.parametrize("calls", [(1, 2), (3, 2), (2, 1), (2, 3)])
def test_nothing_where_the_roots_are_not_one_a_call(recorded, calls):
    recorded(_eager_run())
    got = cells.read_metrics(_eager_ctx(*calls))
    wrong, right = ("api_compress", "api_decompress")[:: 1 if calls[0] != 2 else -1]
    assert not [k for k in NEW if k.endswith(wrong) and k in got]
    assert [k for k in NEW if k.endswith(right)] == [k for k in NEW if k.endswith(right)
                                                     and k in got]


def test_nothing_where_the_program_records_no_spans(monkeypatch):
    """The parent of the recorder: its profiling module has no spans."""
    monkeypatch.delattr(profiling, "spans")
    got = cells.read_metrics(_eager_ctx())
    assert not set(NEW) & set(got)
    assert "collectives.vote_ms.allgather" not in got


def test_nothing_in_a_graph_or_all_gather_cell(recorded):
    recorded(_eager_run())
    graph = {"cell": "bf16-128Mi.graph", "halves": {
        "compress": {"calls": 2, "idle_gaps": {"cudaGraphLaunch": 0.01}, "window_s": 1.0,
                     "busy_s": 0.9, "device_s": 0.9, "least_s": 0.2, "stage_ranges": 0},
        "decompress": {"calls": 2, "idle_gaps": {}, "window_s": 1.0, "busy_s": 0.9,
                       "device_s": 0.9, "least_s": 0.5, "stage_ranges": 0}}}
    got = cells.read_metrics(graph)
    assert set(got) == {"compress_roofline", "decompress_roofline",
                        "device.idle_share.compress", "device.idle_share.decompress"}
    gather = {"cell": "allgather-falcon40b-layer.4chip", "allgather": {
        "calls": 2, "ranks": 4, "least_s": 0.1, "codec_device_s": 0.4, "nccl_s": 0.2,
        "busy_s": 0.5, "window_s": 1.0}}
    assert not set(NEW) & set(cells.read_metrics(gather))


def test_the_vote_reader_takes_rank_0s_vote_spans(recorded):
    ctx = {"cell": "allgather-falcon40b-layer.4chip", "allgather": {
        "calls": 2, "ranks": 4, "least_s": 0.1, "codec_device_s": 0.4, "nccl_s": 0.2,
        "busy_s": 0.5, "window_s": 1.0}}
    run = [_span(1, "collective.vote", None, "0.0", 0, 2 * MS, profiler=False)]
    for n, (t0, ms) in enumerate([(10, 1), (20, 4)]):
        run += [_span(10 + 4 * n, "collective.compress", None, f"0.{n + 1}", t0 * MS,
                      (t0 + 1) * MS),
                _span(11 + 4 * n, "collective.vote", None, f"0.{n + 1}", (t0 + 1) * MS,
                      (t0 + 1 + ms) * MS)]
    recorded(run)
    got = cells.read_metrics(ctx)
    assert got["collectives.vote_ms.allgather"]["value"] == pytest.approx(2.5)
    recorded(run[:-1])
    assert "collectives.vote_ms.allgather" not in cells.read_metrics(ctx)
