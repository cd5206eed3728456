#!/usr/bin/env python3
"""Where the port's time goes on the card, on each path of chip_smoke.py.

With ``dietgpu_tpu_torch``, prob_bits 10, no checksum: path A compresses
and decompresses 128Mi bf16 words (made as bench.py makes them), path B
128Mi f32 words (standard normal), path C encodes and decodes 2^28
exponential bytes (as benchmarks/sweep.py makes them). For each call it
reports:

- wall: CUDA-event time of the call, synchronised, averaged;
- enqueue: host time until the call returns, before synchronising;
- device busy: the sum of kernel times that torch.profiler records over
  the same calls, and the idle share 1 - busy / wall;
- the operations that take the most device time, and the number of
  kernels launched per call.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_port.py

Prints readable lines, then one JSON line with the numbers.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

MWORDS = 128  # bench.py's size, Mi words
ITERS = 10


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import dietgpu_tpu_torch as port
    from dietgpu_tpu_torch import constants as C

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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

    calls = {
        "compress": lambda: port.float_compress_padded(words, n, bf16, 10, False),
        "decompress": lambda: port.float_decompress_padded(
            arc, bf16, Lw, 10, False, static_length=n),
        "f32 compress": lambda: port.float_compress_padded(words_f32, n, f32, 10, False),
        "f32 decompress": lambda: port.float_decompress_padded(
            arc_f32, f32, Lw, 10, False, static_length=n),
        "raw encode": lambda: port.ans_encode_padded(data, L, 10, False),
        "raw decode": lambda: port.ans_decode_padded(arc_raw, 10, L, False),
    }
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
        kernels = [
            e for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
        ]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / ITERS
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / ITERS
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        report[name] = {
            "wall_ms": wall_ms,
            "enqueue_ms": enqueue * 1e3 / ITERS,
            "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "kernels_per_call": len(kernels) / ITERS,
            "top_device_ms": dict(top),
        }
        print(f"# {name}: wall {wall_ms:.4f} ms, host enqueue "
              f"{enqueue * 1e3 / ITERS:.4f} ms, device busy {busy_ms:.4f} ms, "
              f"{len(kernels) / ITERS:.0f} kernels per call ({card})")
        for k, v in top:
            print(f"    {v:9.4f} ms  {k[:90]}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
