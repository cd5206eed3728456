#!/usr/bin/env python3
"""The program's spans (``dietgpu_tpu_torch.profiling``) outside a profiler.

    python3 tools/spans.py cost [--n N] [--device cuda|cpu]
    python3 tools/spans.py eager [--words W] [--calls K]
    python3 tools/spans.py ranks DIR [--share S] [--skip N]

``cost``: host ns a span costs with the recorder off and on (no profiler
in either), over N spans entered back to back, less an empty ``with``.

``eager``: the front end's host time with no profiler. K calls of
``torch_api.compress_data(True, [t])`` round two tensors of W bf16 words
on the card, then K in-place ``torch_api.decompress_data`` of their
archives, as the eager cell calls them, inside ``record_spans()``. For each
half: the wall ms a call, and per call the root span's ms, the codec
glue's (the union of its ``float.*`` / ``ans.*`` spans), the front end's
(root less glue) and the host reads.

``ranks``: the slowest calls of a multi-rank job whose processes ran with
``DIETGPU_SPANS_DIR=DIR``: one ``spans.<pid>.jsonl`` a process, ranks
numbered in the order their processes started (by pid), the first N calls
of each group (warm-up) left out. For each
collective call id, each rank's compress, vote, exchange and decode; a
call's time runs from the first rank's compress start to the last rank's
end. For each stage, the median over all calls and over the slowest share
S of the slowest rank's ms in it. For each of the slowest calls: the rank
that entered the vote last, by how many ms after the first, its own vote
ms (what it still waited once every rank was in: the card or NCCL), and
whether it started late or compressed long against the other ranks'
median.

Each prints one JSON line.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.spans import GLUE, union_ns  # noqa: E402


def cost(n: int, device: str) -> dict:
    import torch

    from dietgpu_tpu_torch import profiling

    class Empty:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def per_span(make):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with make():
                pass
        return (time.perf_counter_ns() - t0) / n

    cuda = device == "cuda"
    rows = {}
    for _ in range(3):  # the last of three rounds, after the first warms up
        empty = per_span(Empty)
        off = per_span(lambda: profiling.annotate("x", cuda))
        with profiling.record_spans():
            on = per_span(lambda: profiling.annotate("x", cuda))
        rows = {"empty_ns": empty, "off_ns": off - empty, "on_ns": on - empty}
    return {"what": "span cost", "device": device, "n": n,
            "torch": torch.__version__, **rows}


def _halves(spans):
    """{root name: [(root, [spans of its call])]}, roots in order."""
    of, roots = {}, {}
    for s in spans:
        of.setdefault(s["call"], []).append(s)
        if s["parent"] is None:
            roots.setdefault(s["name"], []).append(s)
    return {name: [(r, of[r["call"]]) for r in rs] for name, rs in roots.items()}


def eager(words: int, calls: int) -> dict:
    import torch

    from dietgpu_tpu_torch import profiling, torch_api

    g = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn(words, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2)]
    outs = [torch.empty_like(x) for x in xs]
    comps = [None, None]

    def compress(i):
        comps[i] = torch_api.compress_data(True, [xs[i]])[0]

    def decompress(i):
        torch_api.decompress_data(True, [comps[i][0]], [outs[i]])

    for i in range(2):
        compress(i)
        decompress(i)
    torch.cuda.synchronize()
    wall = {}
    with profiling.record_spans() as rec:
        for name, fn in (("front.compress", compress), ("front.decompress", decompress)):
            t0 = time.perf_counter()
            for k in range(calls):
                fn(k % 2)
            torch.cuda.synchronize()
            wall[name] = (time.perf_counter() - t0) / calls * 1e3
    assert all(torch.equal(o.view(torch.int16), x.view(torch.int16)) for o, x in zip(outs, xs))
    out = {"what": "eager calls, no profiler", "words": words, "calls": calls,
           "device_name": torch.cuda.get_device_name()}
    for name, got in _halves(rec.spans()).items():
        root = [r["end_ns"] - r["start_ns"] for r, _ in got]
        glue = [union_ns([s for s in c if s["name"].startswith(GLUE)]) for _, c in got]
        reads = [sum((s["counts"] or {}).get(profiling.HOST_READS, 0) for s in c) for _, c in got]
        out[name] = {
            "calls": len(got), "wall_ms": wall[name],
            "root_ms": statistics.mean(root) / 1e6,
            "glue_ms": statistics.mean(glue) / 1e6,
            "front_ms": statistics.mean(r - g for r, g in zip(root, glue)) / 1e6,
            "front_ms_median": statistics.median(r - g for r, g in zip(root, glue)) / 1e6,
            "host_reads": statistics.mean(reads),
        }
    return out


def ranks(directory: Path, share: float, skip: int) -> dict:
    files = sorted(directory.glob("spans.*.jsonl"), key=lambda p: int(p.name.split(".")[1]))
    stages = ("compress", "vote", "exchange", "decode")
    calls = {}  # call id -> rank -> stage -> (start, end)
    for rank, path in enumerate(files):
        for line in path.read_text().splitlines():
            s = json.loads(line)
            if s["name"].startswith("collective."):
                stage = s["name"].removeprefix("collective.")
                calls.setdefault(s["call"], {}).setdefault(rank, {})[stage] = (
                    s["start_ns"], s["end_ns"])
    whole = {c: r for c, r in calls.items()
             if len(r) == len(files) and all("vote" in st for st in r.values())
             and int(c.rsplit(".", 1)[1]) >= skip}
    if not whole:
        return {"what": "slowest collective calls", "files": len(files), "calls": 0}

    def call_ms(r):
        start = min(st[k][0] for st in r.values() for k in st)
        end = max(st[k][1] for st in r.values() for k in st)
        return (end - start) / 1e6

    def ms(st, stage):
        return (st[stage][1] - st[stage][0]) / 1e6 if stage in st else 0.0

    def slowest_rank_ms(cs, stage):
        """The median over calls `cs` of the slowest rank's ms in `stage`."""
        return statistics.median(max(ms(st, stage) for st in whole[c].values()) for c in cs)

    order = sorted(whole, key=lambda c: call_ms(whole[c]), reverse=True)
    slow = order[: max(1, round(share * len(order)))]
    rows = []
    for c in slow:
        r = whole[c]
        enter = {k: st["vote"][0] for k, st in r.items()}
        last = max(enter, key=enter.get)
        t0 = min(st["compress"][0] for st in r.values())
        late = {  # how much later than the other ranks' median the last one started, compressed
            "start": (r[last]["compress"][0] - t0) / 1e6 - statistics.median(
                (st["compress"][0] - t0) / 1e6 for k, st in r.items() if k != last),
            "compress": ms(r[last], "compress") - statistics.median(
                ms(st, "compress") for k, st in r.items() if k != last),
        }
        by = max(late, key=late.get)
        rows.append({
            "call": c, "call_ms": call_ms(r), "last_into_vote": last,
            "vote_held_ms": (enter[last] - min(enter.values())) / 1e6,
            "last_vote_ms": ms(r[last], "vote"), "by": by, "by_ms": late[by],
            "stage_ms": {k: {s: ms(st, s) for s in stages if s in st}
                         for k, st in sorted(r.items())},
        })
    all_ms = sorted(call_ms(r) for r in whole.values())
    return {
        "what": "slowest collective calls", "files": len(files), "calls": len(whole),
        "call_ms_median": statistics.median(all_ms), "call_ms_max": all_ms[-1], "share": share,
        "slowest_rank_ms": {s: {"all": slowest_rank_ms(order, s), "slow": slowest_rank_ms(slow, s)}
                            for s in stages},
        "last_into_vote": {k: sum(1 for x in rows if x["last_into_vote"] == k)
                           for k in range(len(files))},
        "slowest": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cost")
    c.add_argument("--n", type=int, default=200_000)
    c.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    e = sub.add_parser("eager")
    e.add_argument("--words", type=int, default=512 << 20)
    e.add_argument("--calls", type=int, default=200)
    r = sub.add_parser("ranks")
    r.add_argument("dir", type=Path)
    r.add_argument("--share", type=float, default=0.05)
    r.add_argument("--skip", type=int, default=0)
    a = ap.parse_args(argv)
    if a.cmd == "cost":
        out = cost(a.n, a.device)
    elif a.cmd == "eager":
        out = eager(a.words, a.calls)
    else:
        out = ranks(a.dir, a.share, a.skip)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
