#!/usr/bin/env python3
"""Time the single-tensor calls of two checkouts of the port on one card.

    python3 tools/ab_port.py OTHER_ROOT [--rounds N]

Runs the calls of OTHER_ROOT and of this checkout in turns, OTHER, THIS,
THIS, OTHER (N times over), each in a process of its own that imports
``dietgpu_tpu_torch`` from its root and builds that root's kernels into its
``build/``. A run times a compress and a decompress on paths A (128Mi bf16
words), B (128Mi f32 words) and C (2^28 raw bytes) of chip_smoke.py, with
inputs made as chip_smoke.py makes them, prob_bits 10, no checksum, 20
calls each: the CUDA-event ms per call, and the host's enqueue ms per call
(until the call returns, before synchronising), where the glue between the
kernels shows; and the split, hist, encode and decode kernels alone at
chip_smoke.py's rows of paths A-F, split_f32 at path B's (also on
uniformly random words) and in container mode at path Hf's ragged
lengths, the ragged split at path H's (on normal and on
uniformly random words) and the f32 join at path J's, called as the main
paths call them; the join, tables, sections and assembly kernels at
path A's shape, and the decode's descriptor form at path M's rows. Two
versions are
compared only within one such run. Each child also counts, with
torch.profiler over 10 compress calls, the CUDA
runtime calls a compress makes (kernel launches, copies, stream
synchronisations) and the host ms spent in them: a count that does not
vary from run to run. Where the checkout has stage ranges
(``dietgpu_tpu_torch.profiling``), each child also times the A, B and C
compress with the ranges as they are and with them swapped for a no-op,
in pairs of calls within the process, where the host's spread between
processes does not enter.

With ``--rows api`` a run times only ``api.decompress_data``, the
functional decompress (new outputs, no checksum), at chip_smoke.py's
paths D and H, each archive a row of ``api.compress_data``'s buffer.

Prints a line per run and the medians per tree, then one JSON line.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ITERS = 20
RANGE_PAIRS = 1500  # (on, off) pairs of calls of the ranges' timing, per compress


def encode_row(timed, data32, length, prob_bits, hist, totals):
    """The encode kernel alone on (B, L/4) int32 symbols, each member with
    the table of its own histogram, called as the compress paths call it."""
    from dietgpu_tpu_torch.ans import cuda_encode, stats
    from dietgpu_tpu_torch.ans import encode as plain_encode

    tables = plain_encode.encode_table(stats.normalize_probs(hist, totals, prob_bits))
    return timed(lambda: cuda_encode.encode_blocks_batched_cuda(data32, length, prob_bits, tables))


def split_f32_ragged_row(timed):
    """The f32 split at path H's 64 ragged lengths (chip_smoke.py's path
    Hf: standard-normal f32 words from default_rng(1)), in container mode
    with the lengths on the card, as float_compress_batched calls it."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch.floatcodec import codec, cuda_float

    lens = np.random.default_rng(0).integers(1 << 19, (1 << 21) + 1, 64).tolist()
    width = -(-max(lens) // 4096) * 4096
    rng = np.random.default_rng(1)
    words = torch.zeros((64, width), dtype=torch.int32, device="cuda")
    for m, k in enumerate(lens):
        words[m, :k] = torch.from_numpy(rng.standard_normal(k).astype(np.float32)
                                        .view(np.int32)).cuda()
    lens_t = torch.tensor(lens, dtype=torch.int64, device="cuda")
    arcs = torch.zeros((64, codec.float_archive_buffer_bytes(3, width) // 4), dtype=torch.int32,
                       device="cuda")
    return timed(lambda: cuda_float.split_words_f32_batched_cuda(words, lens, False, arcs[:, 4:],
                                                                 lens_t))


def kernel_rows(port, timed, bf16, f32, raw, arc_c):
    """Every kernel alone at chip_smoke.py's rows: A, B, C, J (the inputs
    above), the batches D, E, F made as chip_smoke.py makes them, H's
    lengths and M's members, called as the main paths call them."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch.ans import cuda_decode, cuda_hist
    from dietgpu_tpu_torch.floatcodec import cuda_float

    n, L = 128 << 20, 1 << 28
    out = {}
    out["kernel split (A)"] = timed(lambda: cuda_float.split_words_batched_cuda(bf16[None], n, 2))
    exp32, nc32, hist, _ = cuda_float.split_words_batched_cuda(bf16[None], n, 2)
    out["kernel encode (A)"] = encode_row(timed, exp32, n, 10, hist, n)
    out["kernel join (J)"] = timed(lambda: cuda_float.join_words_cuda(exp32, nc32, 2))
    out.update(glue_rows(port, timed, bf16, exp32, hist))
    del nc32
    out["kernel split_f32 (B)"] = timed(
        lambda: cuda_float.split_words_f32_batched_cuda(f32[None], n))
    uniform = torch.randint(-(1 << 31), 1 << 31, (1, n), dtype=torch.int32, device="cuda")
    out["kernel split_f32 (B, uniform words)"] = timed(
        lambda: cuda_float.split_words_f32_batched_cuda(uniform, n))
    del uniform
    out["kernel split_f32_ragged (Hf)"] = split_f32_ragged_row(timed)
    e32, lo, hi, _, _ = cuda_float.split_words_f32_batched_cuda(f32[None], n)
    out["kernel join_f32 (J)"] = timed(lambda: cuda_float.join_words_f32_cuda(e32, lo, hi))
    del exp32, e32, lo, hi
    # path H's ragged split: 64 members of 512Ki-2Mi words, the lengths on
    # the card as float_compress_batched passes them; normal words made as
    # chip_smoke.py makes path H's, and uniformly random words (every
    # exponent byte)
    rng = np.random.default_rng(0)
    lens_h = rng.integers(1 << 19, (1 << 21) + 1, 64).tolist()
    width = -(-max(lens_h) // 4096) * 4096
    normal = torch.zeros((64, width), dtype=torch.int16, device="cuda")
    for m, k in enumerate(lens_h):
        x = rng.standard_normal(k).astype(np.float32)
        normal[m, :k] = torch.from_numpy((x.view(np.uint32) >> 16).astype(np.uint16)
                                         .view(np.int16)).cuda()
    lens_t = torch.tensor(lens_h, dtype=torch.int64, device="cuda")
    for words, row in ((normal.view(torch.int32), "normal"),
                       (torch.randint(-(1 << 31), 1 << 31, (64, width // 2), dtype=torch.int32,
                                      device="cuda"), "uniform")):
        out[f"kernel split_ragged (H, {row} words)"] = timed(
            lambda: cuda_float.split_words_batched_cuda(words, lens_h, 2, lengths_t=lens_t))
    del normal, words
    raw32 = raw.view(torch.int32)
    out["kernel hist (C)"] = timed(lambda: cuda_hist.histogram_u8_batched_cuda(raw32[None], [L]))
    out["kernel decode_raw (C)"] = timed(
        lambda: cuda_decode.decode_raw_batched_cuda(arc_c[None], 10, L))
    for row, ft, w in (("decode (A)", 2, bf16), ("decode_f32 (B)", 3, f32)):
        a, _ = port.float_compress_padded(w, n, ft, 10, False)
        out[f"kernel {row}"] = timed(lambda: cuda_decode.decode_float(a, ft, n, 10, n))
    del a
    B, Lm = 128, 1 << 19  # paths D and E
    x = np.random.default_rng(0).standard_normal((B, Lm)).astype(np.float32)
    words_e = torch.from_numpy(x.view(np.int32)).cuda()
    words_d = (words_e >> 16).to(torch.int16).view(torch.int32)
    del x
    out["kernel split_batched (D)"] = timed(
        lambda: cuda_float.split_words_batched_cuda(words_d, Lm, 2))
    exp_d, _, hist_d, _ = cuda_float.split_words_batched_cuda(words_d, Lm, 2)
    out["kernel encode_batched (D)"] = encode_row(timed, exp_d, Lm, 10, hist_d, Lm)
    del exp_d
    for row, ft, w in (("decode_batched (D)", 2, words_d), ("decode_f32_batched (E)", 3, words_e)):
        a, _ = port.float_compress_batched(w, Lm, ft, 10, False)
        out[f"kernel {row}"] = timed(
            lambda: cuda_decode.decode_float_batched_cuda(a, ft, Lm, 10, Lm, False, Lm // 4096))
    del a, words_d, words_e
    rng = np.random.default_rng(0)  # path F
    cap = 1 << 22
    lengths = rng.integers(cap // 4, cap + 1, 64).tolist()
    data = torch.empty((64, cap), dtype=torch.uint8, device="cuda")
    for m, k in enumerate(lengths):
        row = np.minimum(rng.exponential(30, cap), 255).astype(np.uint8)
        row[k:] = 0
        data[m] = torch.from_numpy(row)
    lengths_t = torch.tensor(lengths, dtype=torch.int64, device="cuda")
    d32 = data.view(torch.int32)
    out["kernel hist_batched (F)"] = timed(
        lambda: cuda_hist.histogram_u8_batched_cuda(d32, lengths, False, lengths_t))
    hist_f, _ = cuda_hist.histogram_u8_batched_cuda(d32, lengths, False, lengths_t)
    out["kernel encode_batched (F)"] = encode_row(timed, d32, lengths_t, 10, hist_f, lengths_t)
    arcs, _ = port.ans_encode_batched(data, lengths, None, 10, False)
    out["kernel decode_raw_batched (F)"] = timed(
        lambda: cuda_decode.decode_raw_batched_cuda(arcs, 10, cap))
    del data, d32, arcs
    out.update(member_rows(port, timed, bf16))
    return out


def glue_rows(port, timed, bf16, exp32, hist):
    """The tables, sections and assembly kernels alone at path A's shape,
    on the split and encode kernels' outputs, as the compress paths call
    them."""
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.ans import cuda_encode

    n = bf16.numel() * 2
    arc, _ = port.float_compress_padded(bf16, n, 2, 10, False)
    arcs = torch.zeros_like(arc)[None]
    del arc
    pdfs, tables = cuda_encode.quantize_cuda(hist, n, 10)
    staged, counts, states = cuda_encode.encode_blocks_batched_cuda(exp32, n, 10, tables)
    base32 = 4 + C.round_up(n, 16) // 4

    def sections():
        return cuda_encode.write_sections_batched_cuda(arcs, base32, pdfs, states, counts, [n],
                                                       10)

    prefix, ds32 = sections()[:2]
    return {
        "kernel tables (A)": timed(lambda: cuda_encode.quantize_cuda(hist, n, 10)),
        "kernel sections (A)": timed(sections),
        "kernel assembly (A)": timed(lambda: cuda_encode.assemble_payload_batched_cuda(
            arcs, ds32[0], staged, counts, prefix)),
    }


def member_rows(port, timed, bf16):
    """The decode kernel's descriptor form alone at chip_smoke.py's path M:
    path A's archive into one bf16 tensor, and 24 raw members of
    14,680,064 e4m3 bytes (one expert layer) into their own tensors,
    beside the strided form at the same width."""
    import torch

    from dietgpu_tpu_torch import api
    from dietgpu_tpu_torch.ans import cuda_decode
    from dietgpu_tpu_torch.ans import encode as ans_encode

    n = bf16.numel() * 2
    arc, size = port.float_compress_padded(bf16, n, 2, 10, False)
    arc_a = arc[: int(size) // 4]
    dest = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    out = {"kernel decode_members (M, A)": timed(
        lambda: cuda_decode.decode_members([arc_a], arc.numel(), n, 10, 2, [dest]))}
    del arc, arc_a, dest
    XM, XB = 24, 14_680_064
    gen = torch.Generator(device="cuda").manual_seed(19)
    data = (torch.randn((XM, XB), generator=gen, device="cuda") * 100).clamp(-448, 448)
    data = data.to(torch.float8_e4m3fn).view(torch.uint8)
    arcs, _ = port.ans_encode_batched(data, [XB] * XM, None, 10, False)
    Lx = api._bucket_words(XB)
    a32 = ans_encode.archive_buffer_bytes(Lx) // 4
    staged = torch.zeros((XM, a32), dtype=torch.int32, device="cuda")
    staged[:, : arcs.shape[1]] = arcs
    archives = list(arcs.unbind(0))
    dests = list(torch.empty_like(data).unbind(0))
    out["kernel decode_raw (M, experts, strided)"] = timed(
        lambda: cuda_decode.decode_raw_batched_cuda(staged, 10, Lx))
    out["kernel decode_raw_members (M, experts)"] = timed(
        lambda: cuda_decode.decode_members(archives, a32, Lx, 10, None, dests))
    return out


def api_rows(timed):
    """``api.decompress_data`` (new outputs, no checksum, prob_bits 10) at
    paths D (128 bf16 members of 2^19 words) and H (64 of 512Ki-2Mi words),
    each archive a row of ``api.compress_data``'s buffer, as a caller
    passes them back."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import api

    rng = np.random.default_rng(0)
    out = {}
    for name, lens in (("D", [1 << 19] * 128),
                       ("H", rng.integers(1 << 19, (1 << 21) + 1, 64).tolist())):
        ts = [torch.from_numpy(rng.standard_normal(k).astype(np.float32)).cuda()
              .to(torch.bfloat16) for k in lens]
        arcs = list(api.compress_data(True, ts)[0].unbind(0))
        out[f"api decompress ({name})"] = timed(lambda: api.decompress_data(True, arcs, ts))
    return out


def ranges_rows(calls):
    """Each of `calls` (name -> a compress) with the codec's stage ranges
    as they are ("on") and swapped for a no-op ("off"), in RANGE_PAIRS
    pairs of synchronised calls, the order within a pair flipped every
    pair, so that drifts of the host's speed fall on both alike. Returns
    {name: {on_ms, off_ms, cost, cost_tenths}}: the medians of the calls'
    host ms, the median of the pairs' differences over off_ms, and that
    cost in each tenth of the pairs (their spread); None where the
    checkout has no ranges."""
    import importlib.util

    import torch

    if importlib.util.find_spec("dietgpu_tpu_torch.profiling") is None:
        return None
    from dietgpu_tpu_torch.ans import cuda_encode
    from dietgpu_tpu_torch.floatcodec import codec

    class off:
        __slots__ = ()

        def __init__(self, name, cuda=False):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    modes = (("on", codec.annotate), ("off", off))

    def timed_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {}
    try:
        for name, fn in calls.items():
            pairs = []
            for i in range(RANGE_PAIRS):
                t = {}
                for mode, cls in modes if i % 2 == 0 else modes[::-1]:
                    codec.annotate = cuda_encode.annotate = cls
                    t[mode] = timed_call(fn)
                pairs.append((t["on"], t["off"]))
            off_ms = statistics.median(b for _, b in pairs)
            tenth = RANGE_PAIRS // 10
            out[name] = {
                "on_ms": statistics.median(a for a, _ in pairs), "off_ms": off_ms,
                "cost": statistics.median(a - b for a, b in pairs) / off_ms,
                "cost_tenths": [statistics.median(a - b for a, b in pairs[k : k + tenth]) / off_ms
                                for k in range(0, tenth * 10, tenth)],
            }
    finally:
        codec.annotate = cuda_encode.annotate = modes[0][1]
    return out


def child(root, rows):
    """One timed run of the checkout at `root`, of `rows` ("all" or "api");
    prints one JSON line."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    import dietgpu_tpu_torch as port
    from dietgpu_tpu_torch import _build

    _build.build_all()
    def timed(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        enqueue = 0.0
        a.record()
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fn()
            enqueue += time.perf_counter() - t0
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / ITERS, enqueue * 1e3 / ITERS

    if rows == "api":
        print(json.dumps({"ms": api_rows(timed), "runtime_calls": {}, "ranges": None}))
        return
    n = 128 << 20
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    bf16 = torch.from_numpy((x.view(np.uint32) >> 16).astype(np.uint16).view(np.int32)).cuda()
    f32 = torch.from_numpy(x.view(np.int32)).cuda()
    raw = np.minimum(np.random.default_rng(0).exponential(30, 1 << 28), 255).astype(np.uint8)
    raw = torch.from_numpy(raw).cuda()
    del x

    out = {}
    for name, ft, w in (("A", 2, bf16), ("B", 3, f32)):
        arc, _ = port.float_compress_padded(w, n, ft, 10, False)
        out[f"{name} compress"] = timed(lambda: port.float_compress_padded(w, n, ft, 10, False))
        out[f"{name} decompress"] = timed(
            lambda: port.float_decompress_padded(arc, ft, n, 10, False, static_length=n))
    arc, _ = port.ans_encode_padded(raw, 1 << 28, 10, False)
    out["C compress"] = timed(lambda: port.ans_encode_padded(raw, 1 << 28, 10, False))
    out["C decompress"] = timed(lambda: port.ans_decode_padded(arc, 10, 1 << 28, False))
    out.update(kernel_rows(port, timed, bf16, f32, raw, arc))
    compress_calls = {
        "A": lambda: port.float_compress_padded(bf16, n, 2, 10, False),
        "B": lambda: port.float_compress_padded(f32, n, 3, 10, False),
        "C": lambda: port.ans_encode_padded(raw, 1 << 28, 10, False),
    }
    calls = {}
    for name, fn in compress_calls.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        count = {}
        for e in prof.events():
            if e.name in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize"):
                c = count.setdefault(e.name, [0, 0.0])
                c[0] += 1
                c[1] += e.cpu_time_total / 1e3
        calls[f"{name} compress"] = {k: [c / 10, ms / 10] for k, (c, ms) in count.items()}
    ranges = ranges_rows({f"{k} compress": fn for k, fn in compress_calls.items()})
    print(json.dumps({"ms": out, "runtime_calls": calls, "ranges": ranges}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--rows", choices=("all", "api"), default="all")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.other, args.rows)
    roots = {"other": str(Path(args.other).resolve()),
             "this": str(Path(__file__).resolve().parent.parent)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    runs = []
    for tree in ("other", "this", "this", "other") * args.rounds:
        res = subprocess.run([sys.executable, __file__, roots[tree], "--rows", args.rows,
                              "--child"],
                             capture_output=True, text=True, check=True)
        child_out = json.loads(res.stdout.strip().splitlines()[-1])
        times = child_out["ms"]
        runs.append({"tree": tree, "ms": times, "runtime_calls": child_out["runtime_calls"],
                     "ranges": child_out["ranges"]})
        print(f"# {tree:5s}: " + ", ".join(f"{k} {v[0]:.4f} (enqueue {v[1]:.4f})"
                                           for k, v in times.items()) + f" ms ({card})",
              flush=True)
        for k, v in child_out["runtime_calls"].items():
            print(f"#   {k}, per call: " + ", ".join(f"{c:g} {fn} ({ms:.4f} ms of host)"
                                                      for fn, (c, ms) in v.items()), flush=True)
        for k, v in (child_out["ranges"] or {}).items():
            print(f"#   {k}, stage ranges on {v['on_ms']:.4f} ms, off {v['off_ms']:.4f} ms "
                  f"(medians of {RANGE_PAIRS} pairs of calls): cost {100 * v['cost']:+.3f}% "
                  f"(tenths of the pairs {min(v['cost_tenths']) * 100:+.3f}% to "
                  f"{max(v['cost_tenths']) * 100:+.3f}%)", flush=True)
    medians = {
        tree: {k: [statistics.median(r["ms"][k][i] for r in runs if r["tree"] == tree)
                   for i in (0, 1)]
               for k in runs[0]["ms"]}
        for tree in roots
    }
    for tree, m in medians.items():
        print(f"# median of {tree}: " + ", ".join(f"{k} {v[0]:.4f} (enqueue {v[1]:.4f})"
                                                  for k, v in m.items()) + " ms")
    for tree in roots:
        ranged = [r["ranges"] for r in runs if r["tree"] == tree and r["ranges"]]
        for k in (ranged[0] if ranged else {}):
            costs = sorted(r[k]["cost"] for r in ranged)
            print(f"# {tree}, {k}: the stage ranges' cost over its {len(costs)} runs, median "
                  f"{100 * statistics.median(costs):+.3f}%, from {100 * costs[0]:+.3f}% to "
                  f"{100 * costs[-1]:+.3f}%")
    print(json.dumps({"card": card, "roots": roots, "runs": runs, "medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
