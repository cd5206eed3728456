#!/usr/bin/env python3
"""Where the port's time goes on the card, on each path of chip_smoke.py.

With ``dietgpu_tpu_torch``, prob_bits 10, no checksum: path A compresses
and decompresses 128Mi bf16 words (made as bench.py makes them), path B
128Mi f32 words (standard normal), path C encodes and decodes 2^28
exponential bytes (as benchmarks/sweep.py makes them); the batched paths
D (128 bf16 members of 512Ki words), E (the same in f32) and F (64 raw
members of 1-4 MiB, ragged) as chip_smoke.py makes them; path L
(chip_smoke.py's GPT-2 XL state dict saved to and loaded from a BytesIO
through ``checkpoint``); and the API
paths: G (D's members as 128 tensors through ``torch_api``, decompressed
in place), Gs (the same words as one flat tensor through the split form
of ``torch_api``, into a contiguous output and into the (8192, 8192).t()
of one that is not, and as the rows of one (128, 512Ki) tensor through
the stride form of ``api``) and H (64 ragged bf16 tensors of 512Ki-2Mi words through
``api``); E's split alone, into separate planes; the joins of path J
(A's and B's split planes back into words); and path K, the collectives
of ``dietgpu_tpu_torch.parallel`` at world size 1 over NCCL on A's words
(all-gather, the same at a 1024-byte budget, which goes raw, two-phase
all-gather, all-to-all, reduce-scatter, all-reduce, ppermute), on B's
(all-gather at 7/8 of raw) and C's bytes (shard_compress with and without
shared stats), and the budget vote alone. For each call it reports:

- wall: CUDA-event time of the call, synchronised, averaged;
- enqueue: host time until the call returns, before synchronising;
- device busy: the sum of kernel times that torch.profiler records over
  the same calls, and the idle share 1 - busy / wall;
- the operations that take the most device time, those that take the
  most host time (self time, under the profiler), the number of kernels
  (device events, copies included) and of top-level torch ops launched per
  call.

The batched compress calls of D and F also run at B = 2 (their first two
members): their torch ops per call must not depend on B. The device
events recorded per call are printed beside them; the profiler has been
seen to record fewer in some calls than were launched.

Then it times what one stage range costs the host outside a capture, and
attributes the time of paths A, C and G compress to the codec's
stage ranges (``dietgpu_tpu_torch.profiling``: float.split, float.stats,
float.ans_encode, ans.encode_kernel, ans.sections, ans.assembly and their
``_batched`` forms), from a trace taken with ``profiler_start`` /
``profiler_stop``: for each stage, its host self ms (its range's length
less the stages nested in it) and the device ms of the kernels launched
inside it and in no nested stage; "(outside the stages)" holds the
kernels launched elsewhere in the call (the histogram, the API's glue).
The attribution is ``profiling.stage_account``, with which chip_smoke.py
makes its `stages` line.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_port.py

Prints readable lines, then one JSON line with the numbers.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from dietgpu_tpu_torch.profiling import STAGE_PREFIX, read_trace, stage_account  # noqa: E402


def _under_ranges_only(event) -> bool:
    """Whether a profiler event has no parent but stage ranges: a torch op
    the call launched itself."""
    p = event.cpu_parent
    while p is not None and p.name.startswith(STAGE_PREFIX):
        p = p.cpu_parent
    return p is None


MWORDS = 128  # bench.py's size, Mi words
BATCH, MEMBER_WORDS = 128, 1 << 19  # paths D and E
RAW_MEMBERS, RAW_CAP = 64, 1 << 22  # path F
RAGGED_MEMBERS, RAGGED_WORDS = 64, (1 << 19, 1 << 21)  # path H
ITERS = 10


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    import dietgpu_tpu_torch as port
    from dietgpu_tpu_torch import api, torch_api
    from dietgpu_tpu_torch import constants as C

    card = _card()
    n = MWORDS * 1024 * 1024
    Lw = C.round_up(n, C.DEFAULT_BLOCK_SIZE)
    L = 1 << 28
    bf16, f32 = C.FLOAT_TYPE_BFLOAT16, C.FLOAT_TYPE_FLOAT32
    x = np.random.default_rng(0).standard_normal(Lw).astype(np.float32)
    w = (x.view(np.uint32) >> 16).astype(np.uint16)
    w[n:] = 0
    words = torch.from_numpy(w.view(np.int32)).cuda()
    words_f32 = torch.from_numpy(x.view(np.int32)).cuda()
    raw = np.minimum(np.random.default_rng(0).exponential(30, L), 255).astype(np.uint8)
    data = torch.from_numpy(raw).cuda()
    del x, w, raw
    arc, _ = port.float_compress_padded(words, n, bf16, 10, False)
    arc_f32, _ = port.float_compress_padded(words_f32, n, f32, 10, False)
    arc_raw, _ = port.ans_encode_padded(data, L, 10, False)

    xb = np.random.default_rng(0).standard_normal((BATCH, MEMBER_WORDS)).astype(np.float32)
    words_e = torch.from_numpy(xb.view(np.int32)).cuda()
    words_d = (words_e >> 16).to(torch.int16).view(torch.int32)
    del xb
    rng = np.random.default_rng(0)
    lengths = rng.integers(RAW_CAP // 4, RAW_CAP + 1, RAW_MEMBERS).tolist()
    data_f = torch.empty((RAW_MEMBERS, RAW_CAP), dtype=torch.uint8, device="cuda")
    for m, k in enumerate(lengths):
        row = np.minimum(rng.exponential(30, RAW_CAP), 255).astype(np.uint8)
        row[k:] = 0
        data_f[m] = torch.from_numpy(row)
    Lm = MEMBER_WORDS
    arcs_d, _ = port.float_compress_batched(words_d, Lm, bf16, 10, False)
    arcs_e, _ = port.float_compress_batched(words_e, Lm, f32, 10, False)
    arcs_f, _ = port.ans_encode_batched(data_f, lengths, None, 10, False)
    words_d2, data_f2 = words_d[:2], data_f[:2]  # sliced here, not inside the profiled calls
    ts_g = [words_d[m].view(torch.bfloat16) for m in range(BATCH)]
    outs_g = [torch.empty_like(t) for t in ts_g]
    comp, sizes, _ = torch_api.compress_data(True, ts_g)
    rows_g = [comp[b, :s] for b, s in enumerate(sizes.tolist())]
    flat_g = words_d.view(torch.bfloat16).view(-1)
    splits_g = [MEMBER_WORDS] * BATCH
    x2d_g = flat_g.view(BATCH, MEMBER_WORDS)
    t_c, t_nc = torch.empty_like(flat_g), torch.empty_like(flat_g).view(8192, 8192).t()
    rng = np.random.default_rng(0)
    ts_h = []
    for k in rng.integers(RAGGED_WORDS[0], RAGGED_WORDS[1] + 1, RAGGED_MEMBERS).tolist():
        xh = rng.standard_normal(k).astype(np.float32)
        wh = (xh.view(np.uint32) >> 16).astype(np.uint16).view(np.int16)
        ts_h.append(torch.from_numpy(wh).cuda().view(torch.bfloat16))
    comp, sizes, _ = api.compress_data(True, ts_h)
    rows_h = [comp[b, :s] for b, s in enumerate(sizes.tolist())]
    from dietgpu_tpu_torch.floatcodec import cuda_float

    planes = [x[0] for x in cuda_float.split_words_batched_cuda(words[None], n, bf16)[:2]]
    planes_f32 = [x[0] for x in cuda_float.split_words_f32_batched_cuda(words_f32[None], n)[:3]]

    calls = {
        "compress": lambda: port.float_compress_padded(words, n, bf16, 10, False),
        "decompress": lambda: port.float_decompress_padded(
            arc, bf16, Lw, 10, False, static_length=n),
        "f32 compress": lambda: port.float_compress_padded(words_f32, n, f32, 10, False),
        "f32 decompress": lambda: port.float_decompress_padded(
            arc_f32, f32, Lw, 10, False, static_length=n),
        "raw encode": lambda: port.ans_encode_padded(data, L, 10, False),
        "raw decode": lambda: port.ans_decode_padded(arc_raw, 10, L, False),
        "D compress": lambda: port.float_compress_batched(words_d, Lm, bf16, 10, False),
        "D compress B=2": lambda: port.float_compress_batched(words_d2, Lm, bf16, 10, False),
        "D decompress": lambda: port.float_decompress_batched(
            arcs_d, bf16, Lm, 10, False, static_length=Lm),
        "E compress": lambda: port.float_compress_batched(words_e, Lm, f32, 10, False),
        "E decompress": lambda: port.float_decompress_batched(
            arcs_e, f32, Lm, 10, False, static_length=Lm),
        "F encode": lambda: port.ans_encode_batched(data_f, lengths, None, 10, False),
        "F encode B=2": lambda: port.ans_encode_batched(data_f2, lengths[:2], None, 10, False),
        "F decode": lambda: port.ans_decode_batched(arcs_f, 10, RAW_CAP),
        "G compress": lambda: torch_api.compress_data(True, ts_g),
        "G decompress": lambda: torch_api.decompress_data(True, rows_g, outs_g),
        "Gs split compress": lambda: torch_api.compress_data_split_size(True, flat_g, splits_g),
        "Gs split decompress": lambda: torch_api.decompress_data_split_size(
            True, rows_g, t_c, splits_g),
        "Gs split decompress, t_out not contiguous": lambda: torch_api.decompress_data_split_size(
            True, rows_g, t_nc, splits_g),
        "Gs stride compress": lambda: api.compress_data_stride(True, x2d_g),
        "Gs stride decompress": lambda: api.decompress_data_stride(
            True, rows_g, BATCH, MEMBER_WORDS, torch.bfloat16),
        "H compress": lambda: api.compress_data(True, ts_h),
        "H decompress": lambda: api.decompress_data(True, rows_h, ts_h),
        "E split": lambda: cuda_float.split_words_f32_batched_cuda(words_e, Lm),
        "J join": lambda: port.join_words_packed(*planes, bf16),
        "J join_f32": lambda: port.join_words_packed_f32(*planes_f32),
    }
    # path L: chip_smoke.py's GPT-2 XL state dict through the checkpoint,
    # on a BytesIO
    import io

    from chip_smoke import GPT2_XL, gpt2_state_dict
    from dietgpu_tpu_torch import checkpoint

    sd = gpt2_state_dict(torch.device("cuda"), **GPT2_XL)
    buf = io.BytesIO()
    checkpoint.save_arrays(buf, sd)
    blob = buf.getvalue()
    del buf
    calls.update({
        "L save": lambda: checkpoint.save_arrays(io.BytesIO(), sd),
        "L load": lambda: checkpoint.load_arrays(io.BytesIO(blob)),
    })
    # path K: a world-1 NCCL group (one card; NCCL puts no two ranks of a
    # communicator on one device)
    import os
    import shutil
    import tempfile
    from datetime import timedelta

    from dietgpu_tpu_torch import parallel
    from dietgpu_tpu_torch.parallel import collectives

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rdv = tempfile.mkdtemp(prefix="profile_port_rdv")
    parallel.initialize_process_group(init_method=f"file://{rdv}/rendezvous", world_size=1,
                                      rank=0, timeout=timedelta(seconds=120))
    xk, xk32 = words.view(torch.bfloat16), words_f32.view(torch.float32)
    f32_budget = C.round_up(int(xk32.nbytes * 0.875), 16)
    fits = torch.ones(1, dtype=torch.bool, device="cuda")
    calls.update({
        "K all_gather": lambda: parallel.compressed_all_gather(xk),
        "K all_gather raw": lambda: parallel.compressed_all_gather(xk, budget_bytes=1024),
        "K all_gather_auto": lambda: parallel.compressed_all_gather_auto(xk),
        "K all_to_all": lambda: parallel.compressed_all_to_all(xk[None]),
        "K reduce_scatter": lambda: parallel.compressed_reduce_scatter(xk),
        "K all_reduce": lambda: parallel.compressed_all_reduce(xk),
        "K ppermute": lambda: parallel.compressed_ppermute(xk),
        "K f32 all_gather": lambda: parallel.compressed_all_gather(xk32, budget_bytes=f32_budget),
        "K shard_compress": lambda: parallel.shard_compress(data, L),
        "K shard_compress shared": lambda: parallel.shard_compress(data, L, shared_stats=True),
        "K vote": lambda: collectives._vote(fits, None),
    })
    report = {"card": card, "n_words": n}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        enqueue = 0.0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fn()
            enqueue += time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        wall_ms = start.elapsed_time(end) / ITERS

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        kernels = [  # the stage ranges' spans on the device's timeline are not work
            e for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.name.startswith(STAGE_PREFIX)
        ]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / ITERS
        torch_ops = [
            e for e in prof.events()
            if e.name.startswith("aten::") and _under_ranges_only(e)
        ]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / ITERS
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        host = sorted(((a.key, a.self_cpu_time_total / 1e3 / ITERS) for a in prof.key_averages()),
                      key=lambda kv: -kv[1])[:6]
        report[name] = {
            "wall_ms": wall_ms,
            "enqueue_ms": enqueue * 1e3 / ITERS,
            "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "kernels_per_call": len(kernels) / ITERS,
            "torch_ops_per_call": len(torch_ops) / ITERS,
            "top_device_ms": dict(top),
            "top_host_self_ms": dict(host),
        }
        print(f"# {name}: wall {wall_ms:.4f} ms, host enqueue "
              f"{enqueue * 1e3 / ITERS:.4f} ms, device busy {busy_ms:.4f} ms, "
              f"idle share {report[name]['idle_share']:.4f}, "
              f"{len(kernels) / ITERS:.0f} kernels and {len(torch_ops) / ITERS:.0f} "
              f"torch ops per call ({card})")
        for k, v in top:
            print(f"    {v:9.4f} ms  {k[:90]}")
        for k, v in host:
            print(f"    {v:9.4f} ms host (self)  {k[:80]}")
    torch.distributed.destroy_process_group()
    shutil.rmtree(rdv, ignore_errors=True)
    # the compress glue by stage: paths A, C and G compress under
    # profiler_start / profiler_stop, per call
    from dietgpu_tpu_torch import profiling

    # what a stage range costs the host outside a capture (path A compress
    # enters six, its decompress one, C's encode three; `cuda` pushes NVTX
    # only inside a capture)
    n_ranges = 100000
    range_us = {}
    for nvtx in (False, True):
        t0 = time.perf_counter()
        for _ in range(n_ranges):
            with profiling.annotate("float.split", nvtx):
                pass
        range_us["cuda" if nvtx else "host only"] = (time.perf_counter() - t0) / n_ranges * 1e6
    report["stage range us"] = range_us
    print(f"# a stage range outside a capture: {range_us['host only']:.4f} us, cuda=True "
          f"{range_us['cuda']:.4f} us; six of them {6 * range_us['cuda']:.2f} us "
          f"against path A compress's {report['compress']['wall_ms'] * 1e3:.1f} us ({card})")

    for name in ("compress", "raw encode", "G compress"):
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            profiling.profiler_start(tmp)
            try:
                for _ in range(ITERS):
                    calls[name]()
            finally:
                profiling.profiler_stop()
            rows, _ = stage_account(read_trace(tmp))
        per_call = {stage: {k: (v / ITERS if k != "calls" else v // ITERS) for k, v in r.items()}
                    for stage, r in rows.items()}
        report[f"stages: {name}"] = per_call
        print(f"# stages of {name}, per call ({card}): host self ms, kernel ms")
        for stage, r in per_call.items():
            print(f"    {stage:28s} {r['host_self_ms']:9.4f}  {r['device_self_ms']:9.4f}")
    # normalize_probs on a whole batch of histograms at the widest table:
    # its extra device memory and time
    from dietgpu_tpu_torch.ans import stats

    h = torch.randint(0, 1 << 20, (BATCH, 256), device="cuda")
    tot = h.sum(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    stats.normalize_probs(h, tot, 11)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        stats.normalize_probs(h, tot, 11)
    end.record()
    torch.cuda.synchronize()
    report["normalize_probs B=128 pb 11"] = {
        "peak_extra_bytes": peak, "ms": start.elapsed_time(end) / ITERS,
    }
    print(f"# normalize_probs, {BATCH} histograms, prob_bits 11: {peak} bytes of device "
          f"memory past its inputs, {start.elapsed_time(end) / ITERS:.4f} ms ({card})")
    # the torch ops a call enqueues are what must not grow with B; the
    # device events the profiler records per call are printed beside them
    for path, call in (("D", "D compress"), ("F", "F encode")):
        per = [(report[c]["torch_ops_per_call"], report[c]["kernels_per_call"])
               for c in (f"{call} B=2", call)]
        same = per[0][0] == per[1][0]
        report[f"{path} ops independent of B"] = same
        print(f"# path {path}: torch ops, kernels per batched compress call: B=2 {per[0]}, "
              f"B={BATCH if path == 'D' else RAW_MEMBERS} {per[1]}; torch ops "
              f"{'the same' if same else 'DIFFERENT'}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
