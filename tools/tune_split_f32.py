#!/usr/bin/env python3
"""Time launch shapes of the f32 split kernel (``csrc/split_f32.cu``) on one card.

    python3 tools/tune_split_f32.py [--rounds N]

Builds copies of the kernel's source that differ only in their threads a
CTA, CTAs an SM (the launch bound) and 16-byte loads in flight a thread,
all in parallel into ``build/tune_split_f32/``, and binds
each in turn in place of the built kernel, so that each runs through the
same wrapper (``split_words_f32_batched_cuda``) as the codec calls it.
Each is held bit for bit against the plain version on every input, then
timed with CUDA events, in turns, N rounds, 20 launches a measurement;
prints each one's registers and stack frame (``ptxas -v``), its median ms
on each input beside the bytes bound, then one JSON line. The inputs are
chip_smoke.py's: path B's 128Mi standard-normal words (B), the same into
the float container as the codec calls it (B container), the same size
in uniformly random words (B uniform), path E's 128 x 512Ki batch (E), and
path H's 64 ragged lengths as f32 words in container mode with the
lengths on the card (Hf). One more copy leaves the histogram out (its
counting removed; held against the plain version's planes and checksum
only): what the counting costs, a measurement and not a kernel.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ITERS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# (threads a CTA, CTAs an SM the launch bound asks for, loads in flight)
CONSTANTS = ("kThreads", "kMinBlocks", "kUnroll")
SHAPES = ((256, 6, 2), (256, 6, 1), (256, 6, 4), (512, 3, 2), (256, 5, 4), (256, 4, 4))
NO_COUNT = ("dtt::count4(", "dtt::count_first(")


def variants():
    """{label: (source text, whether its histogram is checked)}: the
    committed source at each launch shape, and without its counting."""
    sys.path.insert(0, str(ROOT))
    from dietgpu_tpu_torch import _build

    src = (_build.CSRC / "split_f32.cu").read_text()
    out = {}
    for shape in SHAPES:
        text = src
        for name, value in zip(CONSTANTS, shape):
            text, k = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            if k != 1:
                raise RuntimeError(f"split_f32.cu: no single constant {name}")
        out["threads %d, CTAs/SM %d, unroll %d" % shape] = (text, True)
    text = src
    for call in NO_COUNT:  # each counting call becomes a no-op expression
        if text.count(call) != 1:
            raise RuntimeError(f"split_f32.cu: no single {call}")
        text = text.replace(call, "(void)(")
    out["committed, NO HISTOGRAM"] = (text, False)
    return out


def build(texts):
    """Compile one library per variant, all in parallel; {label: path}."""
    from dietgpu_tpu_torch import _build

    out_dir = _build.BUILD_DIR / "tune_split_f32"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, (text, _)) in enumerate(texts.items()):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-Xptxas", "-v",
               "-o", str(lib), str(cu)]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT))
    libs = {}
    for label, (lib, proc) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{out}")
        # ptxas -v on the kernel (its first function): stack frame and spills, registers
        info = [line.split(":", 1)[-1].strip() for line in out.splitlines()
                if "stack frame" in line or "Used" in line]
        print(f"# {label}: " + " | ".join(info[:2]), flush=True)
        libs[label] = lib
    return libs


def inputs(dev):
    """{name: (the call's arguments, bytes bound)} of chip_smoke.py's shapes."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import codec

    n = 128 << 20
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    normal = torch.from_numpy(x.view(np.int32)).to(dev)[None]
    uniform = torch.randint(-(1 << 31), 1 << 31, (1, n), dtype=torch.int32, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(10))
    B, Lm = 128, 1 << 19
    x = np.random.default_rng(0).standard_normal((B, Lm)).astype(np.float32)
    batch = torch.from_numpy(x.view(np.int32)).to(dev)
    del x
    lens = np.random.default_rng(0).integers(1 << 19, (1 << 21) + 1, 64).tolist()
    width = -(-max(lens) // 4096) * 4096
    rng = np.random.default_rng(1)
    ragged = torch.zeros((64, width), dtype=torch.int32, device=dev)
    for m, k in enumerate(lens):
        ragged[m, :k] = torch.from_numpy(rng.standard_normal(k).astype(np.float32)
                                         .view(np.int32)).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int64, device=dev)
    arcs = torch.zeros((64, codec.float_archive_buffer_bytes(3, width) // 4), dtype=torch.int32,
                       device=dev)
    ragged_bytes = (4 * sum(lens) + 64 * (width + 4 * 256)
                    + sum(2 * C.round_up(k, 8) + C.round_up(k, 16) for k in lens))
    # B as float_compress_padded calls it: the planes into the container
    arc_b = torch.empty((1, codec.float_archive_buffer_bytes(3, n) // 4), dtype=torch.int32,
                        device=dev)
    return {
        "B": ((normal, n), 8 * n + 4 * 256),
        "B container": ((normal, n, False, arc_b[:, 4:]), 8 * n + 4 * 256),
        "B uniform": ((uniform, n), 8 * n + 4 * 256),
        "E": ((batch, Lm), B * (8 * Lm + 4 * 256)),
        "Hf": ((ragged, lens, False, arcs[:, 4:], lens_t), ragged_bytes),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch

    texts = variants()
    libs = build(texts)
    from dietgpu_tpu_torch import _build
    from dietgpu_tpu_torch.floatcodec import cuda_float

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cases = inputs(dev)
    print(f"# inputs made in {time.perf_counter() - t0:.1f} s; card: {card}", flush=True)
    _, _, argtypes = _build._ENTRY["split_f32"]
    fns = {}
    for label, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).dtt_split_f32
        fn.argtypes = (*argtypes, ctypes.c_void_p)
        fn.restype = ctypes.c_int
        fns[label] = fn

    def use(label):
        _build._entry("split_f32")  # builds and binds the committed kernel first
        _build._entries["split_f32"] = fns[label]

    def call(call_args):
        return cuda_float.split_words_f32_batched_cuda(*call_args)

    for name, (case_args, _) in cases.items():
        plain_args = list(case_args)
        if len(case_args) > 3:  # container mode: the plain version writes its own copy
            plain_args[3] = case_args[3].clone()
        want = cuda_float.split_words_f32_batched_plain(*plain_args)
        for label, (_, counts) in texts.items():
            use(label)
            got = call(case_args)
            for i, (a, b) in enumerate(zip(got, want)):
                if (counts or i != 3) and not torch.equal(a, b):
                    raise AssertionError(f"{label} on {name}: output {i} differs from plain")
        del want, plain_args
        torch.cuda.empty_cache()
        print(f"# {name}: every variant bit-exact against the plain version", flush=True)

    times = {label: {name: [] for name in cases} for label in texts}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(args.rounds):
        for label in texts:
            use(label)
            for name, (a, _) in cases.items():
                for _ in range(2):
                    call(a)
                start.record()
                for _ in range(ITERS):
                    call(a)
                end.record()
                torch.cuda.synchronize()
                times[label][name].append(start.elapsed_time(end) / ITERS)
    rows = []
    for label in texts:
        row = {"variant": label}
        for name, (_, nbytes) in cases.items():
            row[name] = {"ms": statistics.median(times[label][name]),
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        rows.append(row)
        print(f"# {label}: " + ", ".join(
            f"{k} {row[k]['ms']:.4f} ms (bound {row[k]['bound_ms']:.4f})" for k in cases),
            flush=True)
    print(json.dumps({"card": card, "rounds": args.rounds, "iters": ITERS, "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
