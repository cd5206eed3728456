#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``dietgpu_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py            # the full check, about three minutes

Phases; any failure raises, so the script exits non-zero and prints no
result line:

1. build    -- compiles every source of ``dietgpu_tpu_torch/csrc/`` with
               nvcc for sm_90a, all in parallel, into ``build/``, and
               prints the resources of the split, hist, encode, decode and
               join kernels (registers, static and dynamic shared bytes, spill
               bytes, threads and CTAs per SM) on progress lines;
2. kernels  -- each of the twelve kernels (split, split_f32, hist,
               tables, encode, sections, assembly, decode in three
               configurations, join in two;
               every one takes a batch, a single tensor being a batch of
               one) against its plain torch version on the card,
               bit-exact (tolerance 0: the codec is lossless and the
               archive format fixed), at small and ragged shapes: single
               tensors, B = 1, members of one block, ragged raw and float
               lengths, joins on unaligned rows; with a lying header and
               a corrupted payload for each decode (in one member of a
               batch: only it may fail); the API on the card against
               its CPU route; and hist and decode on the inputs their
               designs are at risk on: constant bytes at path C's size,
               alternating values, empty and 1-byte members; maximal
               streams, ragged last steps, one-block members, odd stream
               starts, rows that are not 16-byte aligned, and lying and
               corrupted members, outputs and status equal to the plain
               version's; and encode and the f32 join on theirs: constant,
               alternating and uniform random bytes at prob_bits 9-11, an
               overflowing block, lengths at every edge of a block,
               one-block members, ragged batches that cross the
               persistent CTAs' shares, B = 1 and B = 513, path C's 2^28
               bytes; low-plane rows that are not 8-byte aligned, an n4
               that is not a multiple of 4, a batch; and the split on
               its: constant words, alternating exponents and uniformly
               random words at lengths 0-9 and around 4096, alone and in a
               ragged batch, batches across the persistent CTAs' shares,
               B = 513 and 65537, path A's size in uniform words; and
               65537 members (more than a launch's grid y holds) through
               float_compress_batched / float_decompress_batched in bf16
               and f32 and through both joins; and split_f32 on its:
               constant words, alternating exponents and uniformly random
               words at lengths 0-17, 4095-4097 and 16Ki, alone and in a
               ragged batch, with and without the checksum, in container
               mode into rows 8 bytes past a 16-byte boundary whose words
               past each member's archived ends must keep their -1,
               batches across the CTAs' shares, B = 513, path B's size in
               uniform words;
3. path A   -- bf16, 128Mi words, prob_bits 10, no checksum, inputs made
               exactly as bench.py makes them, through
               float_compress_padded / float_decompress_padded: the launch
               counters must move, the roundtrip must be exact, the
               archive must equal the plain pipeline's on the card byte for
               byte, and the ratio must be 0.6742. Then every kernel of the
               path is held against its plain version again at these
               shapes;
   path B   -- f32, 128Mi words (512 MiB), prob_bits 10, no checksum,
               standard-normal inputs as benchmarks/sweep.py makes them,
               through the same entry points, with the same checks, and one
               call with the checksum verified on decode;
   path C   -- raw ANS, 2^28 bytes (256 MiB), prob_bits 10, exponential
               bytes as benchmarks/sweep.py makes them, through
               ans_encode_padded (its own histogram) / ans_decode_padded,
               with the same checks and one checksummed call;
   path D   -- bf16 batch, 128 members of 512Ki words (128 MiB), prob_bits
               10, no checksum, one static length (benchmarks/sweep.py's
               batched scenario), through float_compress_batched /
               float_decompress_batched: each kernel launched exactly once
               per call, every member round-trips exactly, its
               archive equals the batched plain pipeline's on the card and
               the single-tensor kernel path's, one checksummed call;
   path E   -- the same for an f32 batch of 128 x 512Ki words (256 MiB);
   path F   -- raw ANS batch, 64 members of ragged lengths drawn in
               [1 MiB, 4 MiB], capacity 4 MiB each, exponential bytes,
               through ans_encode_batched (its own histograms) /
               ans_decode_batched, with the same checks at prob_bits 10
               and exactness at 9 and 11;
   path G   -- the reference's 128-way torch-op batch: path D's 128 bf16
               tensors of 512Ki words as separate tensors through
               torch_api.compress_data and the in-place
               torch_api.decompress_data: every archive equals path D's,
               every output its input, each kernel launched once per call;
   path H   -- 64 ragged bf16 tensors, word counts uniform in [512Ki, 2Mi]
               from default_rng(0), through api.compress_data /
               api.decompress_data: every archive equals the member's
               single-tensor float_compress_padded archive; then path F's
               members through api.compress_data(False, ...) (path Hr),
               every archive equal to path F's; and path H's lengths as
               64 f32 tensors (standard normal, default_rng(1); path Hf),
               every archive equal to the member's single-tensor archive;
               each kernel once per call;
   path Gs  -- the split, stride and info forms of both front-ends at
               path G's width: compress_data_split_size of one flat tensor
               of path D's 64Mi words into 128 splits through api and
               torch_api, every archive path D's; decompress_data_split_size
               through api, and through torch_api in place into a contiguous
               t_out, into the (8192, 8192).t() of a bf16 tensor that is not
               contiguous, prefilled with a sentinel, and the same with one
               member's archive swapped for a larger one (status 0 for it, 1
               elsewhere, all of t_out still the sentinel); compress_data_stride
               / decompress_data_stride on the (128, 512Ki) rows with sizes
               alternating 512Ki and 384Ki (every archive the row's
               single-tensor archive, rows zero past their sizes), and with
               one row's archive swapped to fail it; the raw stride form on
               path F's rows (path F's archives); get_compressed_info_device
               on both sets of archives against get_compressed_info and the
               headers, and the max_* queries. Each call launches each of its
               kernels once and no other. The split and stride calls are timed
               beside path G's torch_api calls on the same words (the
               ``front_end`` line);
   path J   -- the standalone join: path A's bf16 and path B's f32 input
               split and joined back (join_words_packed,
               join_words_packed_f32) at 128Mi words, exact against the
               input and the plain join;
   path K   -- the compressed collectives and the shard codec
               (``dietgpu_tpu_torch.parallel``) at world size 1 over NCCL
               (one card; NCCL puts no two ranks of a communicator on one
               device), a file rendezvous in a temporary directory, on A's
               bf16 words (all-gather at the default budget and at 1024
               bytes, which goes raw; the two-phase all-gather; all-to-all
               of one (1, 128Mi) row; reduce-scatter and all-reduce of V =
               128Mi; the default ppermute, a self-edge), B's f32 words
               (all-gather at 7/8 of raw) and C's bytes (shard_compress /
               shard_decompress, shared_stats False and True): each call
               the identity, its flag as expected, each kernel launched
               exactly as many times as the call runs it, every archive it
               compresses to send equal to the plain pipeline's on the
               card; a tensor on the other backend's device refused; and
               at 4096 and 5000 words the same calls on the card (NCCL) and
               on CPU copies (a gloo group of the same rank) with equal
               outputs, flags, budgets and sent archives. Each call's
               median ms of 10 is timed beside the raw collective's on the
               same tensor and group;
4. timing   -- CUDA events: compress and decompress GB/s of each path (for
               D-F also the same batch as B single-tensor calls; G and H
               beside D and the ragged batch's bytes), the joins' GB/s,
               each kernel's ms beside its bound and its plain version's
               ms (and, for the histogram, torch.bincount's; the tables
               and sections kernels, whose wrappers' host code outlasts
               them, timed from a CUDA graph of 20 calls), and a
               measured copy_ of path A's bytes; the decode kernel's
               descriptor form (archives read where they lie, members
               written into their destinations) at path A's shape and at
               one DeepSeek-V3 EP32 expert layer's (24 x 14,680,064 e4m3
               bytes at the API's decode width), beside its strided form;
   captured -- paths A-F, H and Hf (through the batched entry points at
               path H's lengths) compress and decompress, and path J's
               two joins, each captured once in a CUDA graph at full
               width after an eager warm-up under
               torch.cuda.set_sync_debug_mode("error"): the graph records
               each kernel of the call once, and each of 3 replays, on
               inputs copied into the static buffers, equals an eager
               call on the same input bit for bit (archives [0, size),
               sizes, statuses, decoded words, which equal the input) and
               counts no launch; eager and replay calls are timed. Every
               kernel must have run inside a graph;
5. path L   -- a compressed checkpoint of a GPT-2 XL state dict (the
               gpt2-xl configuration of the public GPT-2 release: 48
               layers, width 1600, vocabulary 50257, context 1024; 582
               entries, bf16 matrices and embeddings drawn as GPT-2
               initialises them from a seeded generator on the card, f32
               LayerNorm parameters and biases, an int64 step and a bool
               1024 x 1024 mask; 3.1 GB) through
               ``checkpoint.save_arrays`` / ``load_arrays`` on an
               io.BytesIO, prob_bits 10, checksum on: every tensor back bit
               for bit, one batched decode a group, each entry's archive
               equal to its single-tensor kernel archive, the 40 smallest
               entries' archives equal through device="cpu", a file of the
               first 4 layers on disk equal to the BytesIO bytes, f16,
               bf16 and f32 NaN payloads back bit for bit; then the
               file CLI in subprocesses on the card (compress --float bf16,
               info, decompress of path A's words: path A's archive, the
               words back). Save and load are timed (host medians of 3
               calls) beside torch.save / torch.load of the same state
               dict into a BytesIO;
   stages   -- one path A compress and decompress under
               ``profiling.profiler_start`` / ``profiler_stop``: every
               stage range of the path is in the trace once, and the
               split, tables, encode, sections, assembly and decode
               kernels each launch inside their own stage.

Each path is driven with the launch counters set to 0 just before it and
read just after; a row's `launches` is its kernel's count from the row's
path. The kernels line has a row for each kernel at each path's shapes
that runs it: the single paths' rows (split ... decode_f32), the batched
paths' (split_batched ... decode_raw_batched), which are the same kernels
at paths D-F's shapes, the split at path H's ragged lengths
(split_ragged, timed with the lengths on the card, as the compress path
passes them), the joins at path J's (join, join_f32), split_f32 on
uniformly random words at path B's size (split_f32_uniform, path B's
launches) and in container mode at path Hf's lengths (split_f32_ragged).

Output: progress lines, then a ``{"collectives": {...}}`` JSON line (path
K's rows, labelled world size 1: at one rank each exchange is a copy on the
card, so the times are the codec's cost, not a wire saving), a
``{"checkpoint": {...}}`` line (path L: raw and file bytes, ratio, groups,
save and load ms and GB/s beside torch.save's and torch.load's, the
launches of one save and load, the CLI's seconds), a ``{"stages": {...}}``
line (path A's stages: host ms, self and inclusive, and the device ms of
the kernels launched inside each), a ``{"front_end": {...}}`` line (paths
G and Gs: ms and GB/s of each split, stride and path G call), a
``{"captured": {...}}`` line (each captured call's eager and replay ms and
GB/s and the launches its graph recorded), a
``{"kernels": [...]}`` JSON line, the card's
name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX, nor
ml_dtypes.
"""

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

MWORDS = 128  # paths A and B, Mi words (bench.py's size)
RAW_BYTES = 1 << 28  # path C, the bytes of path A's input
BATCH = 128  # paths D and E, members (the reference's 128-way batch)
MEMBER_WORDS = 1 << 19  # paths D and E, words per member
RAW_MEMBERS = 64  # path F, members (BASELINE.json config 2)
RAW_CAP = 1 << 22  # path F, bytes of capacity per member; lengths in [CAP/4, CAP]
EXPERTS = (24, 14_680_064)  # path M: one EP32 rank's expert matrices of a MoE layer, bytes
RAGGED_MEMBERS = 64  # path H, members
RAGGED_WORDS = (1 << 19, 1 << 21)  # path H, word counts drawn in this range
ITERS = 20  # timed iterations per measurement
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # 32-bit non-tensor peak (fp32 rate; int32 is not faster)

# row -> (source, the TPU kernel it replaces, 32-bit ops per symbol/word,
# the path whose shapes and launches it reports, the kernel's launch counter)
KERNELS = {
    "split": (
        "dietgpu_tpu_torch/csrc/split.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:83", 12, "A", "split",
    ),
    "encode": (
        "dietgpu_tpu_torch/csrc/encode.cu",
        "dietgpu_tpu/ans/pallas_encode.py:216", 16, "A", "encode",
    ),
    "assembly": (
        "dietgpu_tpu_torch/csrc/assembly.cu",
        "dietgpu_tpu/ans/pallas_encode.py:682", 0, "A", "assembly",
    ),
    "tables": (
        "dietgpu_tpu_torch/csrc/stats.cu",
        "none (XLA ops: dietgpu_tpu/ans/stats.py:25, :145)", 0, "A", "tables",
    ),
    "sections": (
        "dietgpu_tpu_torch/csrc/assembly.cu",
        "none (XLA ops: dietgpu_tpu/ans/pallas_encode.py:_encode_stage2)", 0, "A", "sections",
    ),
    "decode": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:121", 16, "A", "decode",
    ),
    "hist": (
        "dietgpu_tpu_torch/csrc/hist.cu",
        "dietgpu_tpu/ans/pallas_hist.py:86", 4, "C", "hist",
    ),
    "decode_raw": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:121", 16, "C", "decode_raw",
    ),
    "split_f32": (
        "dietgpu_tpu_torch/csrc/split_f32.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:288", 12, "B", "split_f32",
    ),
    "decode_f32": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:121", 16, "B", "decode_f32",
    ),
    "split_batched": (
        "dietgpu_tpu_torch/csrc/split.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:83", 12, "D", "split",
    ),
    "encode_batched": (
        "dietgpu_tpu_torch/csrc/encode.cu",
        "dietgpu_tpu/ans/pallas_encode.py:278", 16, "D", "encode",
    ),
    "assembly_batched": (
        "dietgpu_tpu_torch/csrc/assembly.cu",
        "dietgpu_tpu/ans/pallas_encode.py:726", 0, "D", "assembly",
    ),
    "decode_batched": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:392", 16, "D", "decode",
    ),
    "split_f32_batched": (
        "dietgpu_tpu_torch/csrc/split_f32.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:288", 12, "E", "split_f32",
    ),
    "decode_f32_batched": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:392", 16, "E", "decode_f32",
    ),
    "hist_batched": (
        "dietgpu_tpu_torch/csrc/hist.cu",
        "dietgpu_tpu/ans/pallas_hist.py:86", 4, "F", "hist",
    ),
    "decode_raw_batched": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:392", 16, "F", "decode_raw",
    ),
    "split_ragged": (
        "dietgpu_tpu_torch/csrc/split.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:83", 12, "H", "split",
    ),
    "split_f32_uniform": (
        "dietgpu_tpu_torch/csrc/split_f32.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:288", 12, "B", "split_f32",
    ),
    "split_f32_ragged": (
        "dietgpu_tpu_torch/csrc/split_f32.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:288", 12, "Hf", "split_f32",
    ),
    # the descriptor form at path A's shape, and both forms at path M's
    "decode_members": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:392", 16, "M", "decode",
    ),
    "decode_raw_experts": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:392", 16, "M", "decode_raw",
    ),
    "decode_raw_members": (
        "dietgpu_tpu_torch/csrc/decode.cu",
        "dietgpu_tpu/ans/pallas_decode.py:392", 16, "M", "decode_raw",
    ),
    "join": (
        "dietgpu_tpu_torch/csrc/join.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:209", 3, "J", "join",
    ),
    "join_f32": (
        "dietgpu_tpu_torch/csrc/join.cu",
        "dietgpu_tpu/floatcodec/pallas_float.py:399", 3, "J", "join_f32",
    ),
}
# rows timed in a CUDA graph of ITERS calls: kernels of a few microseconds,
# whose wrappers' host code an eager loop would time
GRAPH_TIMED = ("tables", "sections")
# the kernels each path must launch
ENC = ("tables", "encode", "sections", "assembly")  # every compress's kernels after the first
PATH_KERNELS = {
    "A": ("split", *ENC, "decode"),
    "B": ("split_f32", *ENC, "decode_f32"),
    "C": ("hist", *ENC, "decode_raw"),
    "D": ("split", *ENC, "decode"),
    "E": ("split_f32", *ENC, "decode_f32"),
    "F": ("hist", *ENC, "decode_raw"),
    "G": ("split", *ENC, "decode"),
    "H": ("split", *ENC, "decode"),
    "Hr": ("hist", *ENC, "decode_raw"),
    "Hf": ("split_f32", *ENC, "decode_f32"),
    "J": ("split", "join", "split_f32", "join_f32"),
    "L": ("split", "split_f32", "hist", *ENC, "decode", "decode_f32", "decode_raw"),
}
# paths whose calls must launch each kernel once
BATCHED_PATHS = ("D", "E", "F", "G", "H", "Hr", "Hf", "J")


def member_width(lengths):
    """A ragged batch's member width: the longest, to a multiple of 4096."""
    return -(-max(lengths) // 4096) * 4096


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def max_abs_err(pairs):
    """Largest |a - b| over (a, b) tensor pairs, as an int (0 = bit-exact)."""
    import torch

    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def require_exact(what, pairs):
    err = max_abs_err(pairs)
    if err:
        raise AssertionError(f"{what}: kernel differs from its plain version (max abs err {err})")
    log(f"  {what}: bit-exact")
    return err


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """ms of one call of fn, from a CUDA graph of `iters` calls replayed
    once: the device's time for a call so short that an eager loop would
    time its host code."""
    import torch

    fn()  # the kernels built, the geometry made
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def staged_pairs(a, b, counts):
    """(staged rows of two encoders, masked past each block's count)."""
    import torch

    keep = torch.arange(a.shape[1], device=a.device)[None, :] < counts.long()[:, None]
    return [(torch.where(keep, a, 0), torch.where(keep, b, 0))]


def drive(port, name, fn):
    """Run fn with the launch counters at 0; fail if a kernel of the path
    was not launched. Returns (fn's result, the counts)."""
    import torch

    torch.cuda.synchronize()
    port.reset_kernel_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = port.kernel_launches()
    log(f"  launches on path {name}: { {k: v for k, v in launches.items() if v} }")
    for k in PATH_KERNELS[name]:
        require(launches[k] >= 1, f"kernel {k} was not launched on path {name}")
        if name in BATCHED_PATHS:
            require(launches[k] == 1, f"kernel {k} launched {launches[k]} times in one batched call")
    return out, launches


def one(outputs):
    """Member 0 of each output of a call on a batch of one."""
    return tuple(x[0] for x in outputs)


def member_pairs(arcs, sizes, parcs, psizes):
    """(sizes, plain sizes) and each member's archive bytes [0, size) beside
    the other pipeline's, for require_exact."""
    pairs = [(sizes, psizes)]
    for m, s in enumerate(sizes.tolist()):
        pairs.append((arcs[m, : (s & 0x7FFFFFFF) // 4], parcs[m, : (s & 0x7FFFFFFF) // 4]))
    return pairs


def phase2_new_kernels(port, dev):
    """The kernels of the f32 and raw-ANS paths against their plain versions
    at small and ragged shapes."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.ans import cuda_decode, cuda_encode, cuda_hist
    from dietgpu_tpu_torch.floatcodec import codec, cuda_float

    F32 = C.FLOAT_TYPE_FLOAT32
    gen = torch.Generator(device=dev).manual_seed(1)
    Lw = 1 << 20
    words = torch.randint(-(1 << 31), 1 << 31, (Lw,), dtype=torch.int32, device=dev,
                          generator=gen)
    for n in (Lw, Lw - 12345):
        for ck in (False, True):
            require_exact(
                f"split_f32 n={n} ck={ck}",
                zip(one(cuda_float.split_words_f32_batched_cuda(words[None], n, ck)),
                    cuda_float.split_words_f32_plain(words, n, ck)),
            )
    for n in (4 * Lw, 4 * Lw - 1, 4 * Lw - 12345, 4097, 3, 0):  # ends inside a word
        require_exact(
            f"hist length={n} ck=True",
            zip(one(cuda_hist.histogram_u8_batched_cuda(words[None], [n], True)),
                cuda_hist.histogram_u8_plain(words, n, True)),
        )

    x = torch.randn(Lw, generator=gen, device=dev).view(torch.int32)
    n = Lw - 777
    for pb in C.SUPPORTED_PROB_BITS:
        for ck in (False, True):
            ka, ks = codec.float_compress_padded(x, n, F32, pb, ck)
            pa, ps = codec.float_compress_padded_plain(x, n, F32, pb, ck)
            size = int(ks)
            require_exact(f"f32 archive pb={pb} ck={ck}",
                          [(ks, ps), (ka[: size // 4], pa[: size // 4])])
            for digest in (False, True):
                require_exact(
                    f"decode_f32 pb={pb} ck={ck} digest={digest}",
                    zip(cuda_decode.decode_float(ka, F32, Lw, pb, n, digest),
                        cuda_decode.decode_float_plain(ka, F32, Lw, pb, n, digest)),
                )
            r = codec.float_decompress_padded(ka, F32, Lw, pb, ck, static_length=n)
            require(bool(r["success"]) and bool(r["checksum_ok"]), "f32 small roundtrip status")
            require(torch.equal(r["out32"][:n], x[:n]), "f32 small roundtrip differs")
    # a lying header and a corrupted payload (ka: the last, checksummed archive)
    bad = ka.clone()
    bad[1] += 4096
    for fn in (cuda_decode.decode_float, cuda_decode.decode_float_plain):
        require(not bool(fn(bad, F32, Lw, pb)[1]), "a lying f32 header decoded with success")
    bad = ka.clone()
    bad[4 + 100] ^= 0x01000000  # a byte of the low plane
    r = codec.float_decompress_padded(bad, F32, Lw, pb, True)
    require(bool(r["success"]) and not bool(r["checksum_ok"]),
            "a corrupted f32 plane byte passed the checksum")
    log("  f32: lying header fails success; corrupted payload fails checksum_ok")

    L = 1 << 20
    n = L - 4097
    rng = np.random.default_rng(2)
    data = torch.from_numpy(np.minimum(rng.exponential(30, L), 255).astype(np.uint8)).to(dev)
    for pb in C.SUPPORTED_PROB_BITS:
        for ck in (False, True):
            ka, ks = port.ans_encode_padded(data, n, pb, ck)
            pa, ps = cuda_encode.ans_encode_padded_plain(data, n, pb, ck)
            size = int(ks)
            require_exact(f"raw archive pb={pb} ck={ck}",
                          [(ks, ps), (ka[: size // 4], pa[: size // 4])])
            for digest in (False, True):
                require_exact(
                    f"decode_raw pb={pb} ck={ck} digest={digest}",
                    zip(one(cuda_decode.decode_raw_batched_cuda(ka[None], pb, L, None, digest)),
                        cuda_decode.decode_raw_plain(ka, pb, L, digest)),
                )
            r = port.ans_decode_padded(ka, pb, L, ck)
            require(bool(r["success"]) and bool(r["checksum_ok"]), "raw small roundtrip status")
            require(torch.equal(r["out"][:n], data[:n]) and not r["out"][n:].any(),
                    "raw small roundtrip differs")
    # lying headers: a size past the capacity fails success; a block count
    # past the buffer leaves success as the format defines it (magic,
    # prob_bits, size) and decodes garbage without a fault -- garbage that
    # may differ between the kernel and the plain version, whose clamps
    # differ past the archive's real sections
    bad = ka.clone()
    bad[2] = L + 1
    for ok in (one(cuda_decode.decode_raw_batched_cuda(bad[None], pb, L))[1],
               cuda_decode.decode_raw_plain(bad, pb, L)[1]):
        require(not bool(ok), "a lying raw header decoded with success")
    bad = ka.clone()
    bad[1] = 0xFFFF
    got = one(cuda_decode.decode_raw_batched_cuda(bad[None], pb, L, None, True))
    torch.cuda.synchronize()
    require(bool(got[1]) == bool(cuda_decode.decode_raw_plain(bad, pb, L)[1]),
            "a lying raw block count changed success")
    bad = ka.clone()
    bad[136 + 5] ^= 0x10  # a lane's final state: decodes, to other bytes
    r = port.ans_decode_padded(bad, pb, L, True)
    require(bool(r["success"]) and not bool(r["checksum_ok"]),
            "a corrupted raw payload passed the checksum")
    log("  raw: lying header fails success; corrupted payload fails checksum_ok")


def phase2_batched_kernels(port, dev):
    """The kernels against their plain versions on small and ragged
    batches: B = 1, members of one block, ragged raw lengths, a lying
    header in one member and a corrupted payload in another."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.ans import cuda_decode, cuda_encode, cuda_hist
    from dietgpu_tpu_torch.floatcodec import codec, cuda_float

    F16, BF16, F32 = C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16, C.FLOAT_TYPE_FLOAT32
    gen = torch.Generator(device=dev).manual_seed(3)
    Lw = 1 << 16
    pairs = torch.randint(-(1 << 31), 1 << 31, (3, Lw // 2), dtype=torch.int32, device=dev,
                          generator=gen)
    words = torch.randint(-(1 << 31), 1 << 31, (3, Lw), dtype=torch.int32, device=dev,
                          generator=gen)
    for B in (1, 3):
        for n in (Lw, Lw - 12345, 17):
            for ck in (False, True):
                for ft in (F16, BF16):
                    require_exact(
                        f"batched split B={B} ft={ft} n={n} ck={ck}",
                        zip(cuda_float.split_words_batched_cuda(pairs[:B], n, ft, ck),
                            cuda_float.split_words_batched_plain(pairs[:B], n, ft, ck)),
                    )
                require_exact(
                    f"batched split_f32 B={B} n={n} ck={ck}",
                    zip(cuda_float.split_words_f32_batched_cuda(words[:B], n, ck),
                        cuda_float.split_words_f32_batched_plain(words[:B], n, ck)),
                )
    lengths = [4 * Lw, 4 * Lw - 3, 4097, 1, 0]
    data = torch.randint(-(1 << 31), 1 << 31, (5, Lw), dtype=torch.int32, device=dev,
                         generator=gen)
    for ck in (False, True):
        require_exact(
            f"batched hist lengths={lengths} ck={ck}",
            zip(cuda_hist.histogram_u8_batched_cuda(data, lengths, ck),
                cuda_hist.histogram_u8_batched_plain(data, lengths, ck)),
        )

    # float batches: the encode and assembly kernels through the batched
    # compress, the decode kernels beside their plain versions
    x = torch.randn((3, Lw), generator=gen, device=dev)
    x = x * torch.arange(1, 4, device=dev)[:, None] ** 3  # a table per member
    as_words = {
        F16: x.half().view(torch.int16), BF16: (x.view(torch.int32) >> 16).to(torch.int16),
        F32: x.view(torch.int32),
    }
    for ft, w in as_words.items():
        for B, lw, n in ((1, Lw, Lw), (3, Lw, Lw - 777), (3, C.DEFAULT_BLOCK_SIZE, 17)):
            wb = w[:B, :lw].contiguous()
            for pb in C.SUPPORTED_PROB_BITS if ft == BF16 else (10,):
                for ck in (False, True):
                    what = f"ft={ft} B={B} Lw={lw} n={n} pb={pb} ck={ck}"
                    snb = cuda_decode.static_block_count(n, lw)
                    ka, ks = codec.float_compress_batched(wb, n, ft, pb, ck)
                    pa, ps = codec.float_compress_batched_plain(wb, n, ft, pb, ck)
                    require_exact(f"batched encode+assembly {what}",
                                  member_pairs(ka, ks, pa, ps))
                    single = [codec.float_compress_padded(wb[m], n, ft, pb, ck) for m in range(B)]
                    require_exact(f"  the same members through the single path {what}",
                                  member_pairs(ka, ks, torch.stack([a for a, _ in single]),
                                               torch.stack([s for _, s in single])))
                    for digest in (False, True):
                        require_exact(
                            f"batched decode{'_f32' if ft == F32 else ''} {what} digest={digest}",
                            zip(cuda_decode.decode_float_batched_cuda(ka, ft, lw, pb, n, digest,
                                                                      snb),
                                cuda_decode.decode_float_batched_plain(ka, ft, lw, pb, n, digest,
                                                                       snb)),
                        )
                    r = codec.float_decompress_batched(ka, ft, lw, pb, ck, static_length=n)
                    require(bool(r["success"].all()) and bool(r["checksum_ok"].all()),
                            f"batched float roundtrip status {what}")
                    out = r["out32"].view(wb.dtype)
                    require(torch.equal(out[:, :n], wb[:, :n]) and not out[:, n:].any(),
                            f"batched float roundtrip differs {what}")
        # ka: B = 3 members of 17 words with a checksum; re-made at Lw - 777
        wb = w.contiguous()
        ka, _ = codec.float_compress_batched(wb, Lw - 777, ft, 10, True)
        bad = ka.clone()
        bad[1, 1] += 4096
        for fn in (cuda_decode.decode_float_batched_cuda, cuda_decode.decode_float_batched_plain):
            require(fn(bad, ft, Lw, 10)[1].tolist() == [True, False, True],
                    f"a lying header in member 1 (ft={ft}) failed another member")
        bad = ka.clone()
        bad[2, 4 + 100] ^= 0x01000000  # a raw-plane byte of member 2
        r = codec.float_decompress_batched(bad, ft, Lw, 10, True)
        require(bool(r["success"].all()) and r["checksum_ok"].tolist() == [True, True, False],
                f"a corrupted plane byte of member 2 (ft={ft}) was not caught in it alone")
        require(torch.equal(r["out32"].view(wb.dtype)[:2, : Lw - 777], wb[:2, : Lw - 777]),
                f"members beside a corrupted one (ft={ft}) differ")
    log("  float batches: a lying header or a corrupted plane fails only its member")

    # raw batches: ragged lengths, a member of one byte (one block), B = 1
    L = 1 << 16
    rng = np.random.default_rng(4)
    lengths = [L, 1, L - 4097, 5000]
    d = np.minimum(rng.exponential(30, (4, L)), 255).astype(np.uint8)
    for m, n in enumerate(lengths):
        d[m, n:] = 0
    d = torch.from_numpy(d).to(dev)
    for lens in ([L - 4097], lengths):
        db = d[2:3] if len(lens) == 1 else d
        for pb in C.SUPPORTED_PROB_BITS:
            for ck in (False, True):
                what = f"lengths={lens} pb={pb} ck={ck}"
                ka, ks = port.ans_encode_batched(db, lens, None, pb, ck)
                pa, ps = cuda_encode.ans_encode_batched_plain(db, lens, None, pb, ck)
                require_exact(f"batched hist+encode+assembly {what}",
                              member_pairs(ka, ks, pa, ps))
                single = [port.ans_encode_padded(db[m], n, pb, ck) for m, n in enumerate(lens)]
                require_exact(f"  the same members through the single path {what}",
                              member_pairs(ka, ks, torch.stack([a for a, _ in single]),
                                           torch.stack([s for _, s in single])))
                for digest in (False, True):
                    require_exact(
                        f"batched decode_raw {what} digest={digest}",
                        zip(cuda_decode.decode_raw_batched_cuda(ka, pb, L, None, digest),
                            cuda_decode.decode_raw_batched_plain(ka, pb, L, None, digest)),
                    )
                r = port.ans_decode_batched(ka, pb, L, verify_checksum=ck)
                require(bool(r["success"].all()) and bool(r["checksum_ok"].all())
                        and torch.equal(r["out"], db), f"raw batched roundtrip {what}")
    # ka: the four members with a checksum at pb 11
    bad = ka.clone()
    bad[0, 2] = L + 1
    for fn in (cuda_decode.decode_raw_batched_cuda, cuda_decode.decode_raw_batched_plain):
        require(fn(bad, pb, L)[1].tolist() == [False, True, True, True],
                "a lying raw header in member 0 failed another member")
    # a block count past member 1's row: success as the format defines it,
    # the same for the kernel and the plain version, and no fault; the
    # neighbours decode exactly
    bad = ka.clone()
    bad[1, 1] = 0xFFFF
    got = cuda_decode.decode_raw_batched_cuda(bad, pb, L)
    torch.cuda.synchronize()
    require(torch.equal(got[1], cuda_decode.decode_raw_batched_plain(bad, pb, L)[1]),
            "a lying raw block count changed success")
    out = got[0].view(torch.uint8)
    require(torch.equal(out[[0, 2, 3]], d[[0, 2, 3]]), "members beside a lying one differ")
    bad = ka.clone()
    bad[3, 136 + 5] ^= 0x10  # a lane's final state of member 3
    r = port.ans_decode_batched(bad, pb, L, verify_checksum=True)
    require(bool(r["success"].all()) and r["checksum_ok"].tolist() == [True, True, True, False],
            "a corrupted payload of member 3 was not caught in it alone")
    log("  raw batches: a lying header or a corrupted payload fails only its member")


def phase2_slice4(port, dev):
    """The join kernels, the split kernels at ragged lengths (split_f32 in
    its container mode too) and the API's ragged batches against their
    plain versions, at small shapes."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import api, torch_api
    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import codec, cuda_float

    F16, BF16, F32 = C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16, C.FLOAT_TYPE_FLOAT32
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    for B, n4 in ((1, 1 << 18), (3, 1000), (3, 4097), (1, 1)):
        e, c, h, lo = rand(B, n4 + 1), rand(B, n4 + 1), rand(B, n4 + 1), rand(B, 2 * n4 + 2)
        for off in (0, 1):  # rows 16-byte aligned (vector form) or not
            ev, cv, hv = e[:, off : off + n4], c[:, off : off + n4], h[:, off : off + n4]
            lv = lo[:, 2 * off : 2 * off + 2 * n4]
            for ft in (F16, BF16):
                require_exact(f"join ft={ft} B={B} n4={n4} offset={off}",
                              [(cuda_float.join_words_cuda(ev, cv, ft),
                                cuda_float.join_words_plain(ev, cv, ft))])
            require_exact(f"join_f32 B={B} n4={n4} offset={off}",
                          [(cuda_float.join_words_f32_cuda(ev, lv, hv),
                            cuda_float.join_words_f32_plain(ev, lv, hv))])

    Lw = 1 << 16
    lens = [Lw, 0, 1, 4095, Lw - 12345]
    B = len(lens)
    pairs, words = rand(B, Lw // 2), rand(B, Lw)
    for ck in (False, True):
        for ft in (F16, BF16):
            require_exact(f"ragged split ft={ft} lengths={lens} ck={ck}",
                          zip(cuda_float.split_words_batched_cuda(pairs, lens, ft, ck),
                              cuda_float.split_words_batched_plain(pairs, lens, ft, ck)))
        require_exact(f"ragged split_f32 lengths={lens} ck={ck}",
                      zip(cuda_float.split_words_f32_batched_cuda(words, lens, ck),
                          cuda_float.split_words_f32_batched_plain(words, lens, ck)))
        R = codec.float_archive_buffer_bytes(F32, Lw) // 4
        pk = rand(B, R)
        pp = pk.clone()
        require_exact(f"ragged split_f32 into containers lengths={lens} ck={ck}",
                      zip(cuda_float.split_words_f32_batched_cuda(words, lens, ck,
                                                                  planes_out=pk[:, 4:]),
                          cuda_float.split_words_f32_batched_plain(words, lens, ck,
                                                                   planes_out=pp[:, 4:])))

    x = torch.randn((B, Lw), generator=gen, device=dev)
    x = x * torch.arange(1, B + 1, device=dev)[:, None]
    as_words = {F16: x.half().view(torch.int16), BF16: (x.view(torch.int32) >> 16).to(torch.int16),
                F32: x.view(torch.int32)}
    for ft, w in as_words.items():
        for pb in C.SUPPORTED_PROB_BITS:
            for ck in (False, True):
                what = f"ft={ft} lengths={lens} pb={pb} ck={ck}"
                ka, ks = codec.float_compress_batched(w, lens, ft, pb, ck)
                pa, ps = codec.float_compress_batched_plain(w, lens, ft, pb, ck)
                require_exact(f"ragged float batch {what}", member_pairs(ka, ks, pa, ps))
                single = [codec.float_compress_padded(w[m], n, ft, pb, ck)
                          for m, n in enumerate(lens)]
                require_exact(f"  the same members through the single path {what}",
                              member_pairs(ka, ks, torch.stack([a for a, _ in single]),
                                           torch.stack([s for _, s in single])))
                r = codec.float_decompress_batched(ka, ft, Lw, pb, ck)
                out = r["out32"].view(w.dtype)
                valid = torch.arange(Lw, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
                require(bool(r["success"].all()) and bool(r["checksum_ok"].all())
                        and torch.equal(out, torch.where(valid, w, 0)),
                        f"ragged float batch roundtrip {what}")

    # the API on the card against the API on the CPU, float and raw
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for n in (0, 1, 4097, 70000)]
    for dtype in (torch.float16, torch.bfloat16, torch.float32):
        ts = [t.to(dtype) for t in xs]
        for ck in (False, True):
            kc, ksz, ktm = api.compress_data(True, [t.to(dev) for t in ts], ck)
            pc, psz, ptm = api.compress_data(True, ts, ck)
            require(ksz.tolist() == psz.tolist() and ktm == ptm, f"API sizes {dtype} ck={ck}")
            require_exact(f"API float archives {dtype} ck={ck}",
                          [(kc[b, :s].cpu(), pc[b, :s]) for b, s in enumerate(psz.tolist())])
            outs = [torch.empty_like(t, device=dev) for t in ts]
            st, _, _ = torch_api.decompress_data(
                True, [kc[b, :s] for b, s in enumerate(ksz.tolist())], outs, ck)
            require(st.tolist() == [1] * len(ts)
                    and all(torch.equal(o.cpu(), t) for o, t in zip(outs, ts)),
                    f"API float roundtrip {dtype} ck={ck}")
    bs = [torch.from_numpy(np.minimum(rng.exponential(30, n), 255).astype(np.uint8))
          for n in (0, 1, 4096, 10001)]
    kc, ksz, _ = api.compress_data(False, [b.to(dev) for b in bs], True)
    pc, psz, _ = api.compress_data(False, bs, True)
    require_exact("API raw archives",
                  [(ksz.cpu(), psz)] + [(kc[b, :s].cpu(), pc[b, :s])
                                        for b, s in enumerate(psz.tolist())])
    outs = api.decompress_data_simple(False, [kc[b, :s] for b, s in enumerate(ksz.tolist())], True)
    require(all(torch.equal(o.cpu(), b) for o, b in zip(outs, bs)), "API raw roundtrip")
    log("  API on the card: archives equal the CPU route's, roundtrips exact")


def phase2_slice5(port, dev):
    """The redesigned hist and decode kernels against their plain versions
    on the inputs the designs are at risk on, bit-exact (outputs, status
    and digest): constant bytes at path C's size (a bin of 2^28 counts),
    two alternating values, ragged batches with empty and 1-byte members;
    for decode, maximal streams (uniform random bytes at prob_bits 11),
    ragged last steps, one-block members in a ragged batch, block streams
    whose start word is odd, rows that are not 16-byte aligned, and in one
    batch a lying size, a lying block count, a corrupted final state and a
    corrupted stream or plane word, each in a member of its own."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.ans import cuda_decode, cuda_hist
    from dietgpu_tpu_torch.floatcodec import codec

    L = RAW_BYTES
    for val in (0x00, 0xFF):
        d32 = torch.full((L // 4,), -1 if val else 0, dtype=torch.int32, device=dev)
        require_exact(f"hist {L} bytes of {val:#04x}",
                      zip(one(cuda_hist.histogram_u8_batched_cuda(d32[None], [L], True)),
                          cuda_hist.histogram_u8_plain(d32, L, True)))
    del d32
    Lm = 1 << 22
    lengths = [0, 1, Lm, 0, 1, Lm - 7]
    B = len(lengths)
    gen = torch.Generator(device=dev).manual_seed(7)
    fills = {
        "random": torch.randint(-(1 << 31), 1 << 31, (B, Lm // 4), dtype=torch.int32,
                                device=dev, generator=gen),
        "0x00": torch.zeros((B, Lm // 4), dtype=torch.int32, device=dev),
        "0xff": torch.full((B, Lm // 4), -1, dtype=torch.int32, device=dev),
        "alternating": torch.full((B, Lm // 4), 0x01FE01FE, dtype=torch.int32, device=dev),
    }
    for name, data in fills.items():
        require_exact(f"batched hist {name} lengths={lengths}",
                      zip(cuda_hist.histogram_u8_batched_cuda(data, lengths, True),
                          cuda_hist.histogram_u8_batched_plain(data, lengths, True)))
    del fills, data
    # more members than one round of the kernels' member scans (512 for
    # hist, 128 for decode), most of them empty or short
    rng = np.random.default_rng(9)
    Lb = 3 * 4096
    many = rng.integers(0, Lb + 1, 1100)
    many[rng.random(1100) < 0.3] = 0
    many = many.tolist()
    db = torch.from_numpy(np.minimum(rng.exponential(20, (1100, Lb)), 255).astype(np.uint8))
    db = db.to(dev)
    require_exact(f"batched hist, {len(many)} members",
                  zip(cuda_hist.histogram_u8_batched_cuda(db.view(torch.int32), many, True),
                      cuda_hist.histogram_u8_batched_plain(db.view(torch.int32), many, True)))
    arcs, _ = port.ans_encode_batched(db[:300], many[:300], None, 10, True)
    require_exact("batched decode_raw, 300 members",
                  zip(cuda_decode.decode_raw_batched_cuda(arcs, 10, Lb, None, True),
                      cuda_decode.decode_raw_batched_plain(arcs, 10, Lb, None, True)))
    wb = torch.randint(-(1 << 15), 1 << 15, (300, 2 * Lb), dtype=torch.int16, device=dev,
                       generator=gen)
    for ft, w in ((C.FLOAT_TYPE_BFLOAT16, wb), (C.FLOAT_TYPE_FLOAT32, wb.view(torch.int32))):
        Lw = w.shape[1]  # words a member
        arcs, _ = codec.float_compress_batched(w, many[:300], ft, 10, True)
        require_exact(f"batched decode ft={ft}, 300 members",
                      zip(cuda_decode.decode_float_batched_cuda(arcs, ft, Lw, 10, None, True),
                          cuda_decode.decode_float_batched_plain(arcs, ft, Lw, 10, None, True)))
    del db, wb, arcs

    def set_odd_starts(arcs, m, base):
        nb = int(arcs[m, base + 1])
        bw = base + 136 + 32 * nb
        arcs[m, bw + 1 : bw + 2 * nb : 2] |= 1

    def misaligned(arcs):
        """The same archives at a stride of one more u32: rows at 4 bytes
        past a 16-byte boundary, every other one."""
        wide = torch.zeros((arcs.shape[0], arcs.shape[1] + 1), dtype=arcs.dtype, device=dev)
        wide[:, :-1] = arcs
        return wide

    # raw archives
    Lr = 1 << 18
    lens = [Lr, 1, Lr - 3 * 4096 - 17, 4096, 33, Lr - 5]
    rng = np.random.default_rng(8)
    d = np.minimum(rng.exponential(30, (len(lens), Lr)), 255).astype(np.uint8)
    d[0] = rng.integers(0, 256, Lr, dtype=np.uint8)  # maximal streams
    for m, n in enumerate(lens):
        d[m, n:] = 0
    d = torch.from_numpy(d).to(dev)
    for pb in C.SUPPORTED_PROB_BITS:
        arcs, _ = port.ans_encode_batched(d, lens, None, pb, True)
        odd = arcs.clone()
        set_odd_starts(odd, 0, 0)
        set_odd_starts(odd, 2, 0)
        bad = arcs.clone()
        bad[1, 2] = Lr + 1  # a size past the capacity
        bad[3, 1] = 0xFFFF  # a block count past the row
        bad[4, 136 + 5] ^= 0x10  # a lane's final state
        nb0 = int(bad[2, 1])
        bad[2, 136 + 32 * nb0 + 2 * (nb0 + (nb0 & 1)) + 40] ^= 0x00010000  # a stream word
        cases = {"as written": arcs, "odd stream starts": odd, "faults": bad,
                 "rows not 16-byte aligned": misaligned(bad)}
        for what, a in cases.items():
            require_exact(f"decode_raw pb={pb} lengths={lens}: {what}",
                          zip(cuda_decode.decode_raw_batched_cuda(a, pb, Lr, None, True),
                              cuda_decode.decode_raw_batched_plain(a, pb, Lr, None, True)))
        r = port.ans_decode_batched(odd, pb, Lr)
        require(bool(r["success"].all()) and torch.equal(r["out"], d),
                f"raw archives with odd stream starts decode to their bytes, pb={pb}")
    log("  decode_raw: the same bytes and status as the plain version on every fault")

    # float containers
    Lw = 1 << 16
    fl = [Lw, 1, Lw - 777, 4096, 0]
    x = torch.randn((len(fl), Lw), generator=gen, device=dev)
    x[0] = torch.rand(Lw, generator=gen, device=dev) * 2 - 1
    as_words = {C.FLOAT_TYPE_FLOAT16: x.half().view(torch.int16),
                C.FLOAT_TYPE_BFLOAT16: (x.view(torch.int32) >> 16).to(torch.int16),
                C.FLOAT_TYPE_FLOAT32: x.view(torch.int32)}
    for ft, w in as_words.items():
        f32 = ft == C.FLOAT_TYPE_FLOAT32
        for pb in C.SUPPORTED_PROB_BITS:
            arcs, _ = codec.float_compress_batched(w, fl, ft, pb, True)

            def ans_base(n):
                b = 4 + C.round_up(n, 16) // 4
                return b + C.round_up(n, 8) // 2 if f32 else b

            odd = arcs.clone()
            set_odd_starts(odd, 0, ans_base(fl[0]))
            set_odd_starts(odd, 2, ans_base(fl[2]))
            bad = arcs.clone()
            bad[1, 1] += 4096  # a lying word count
            bad[0, 4 + 100] ^= 0x01000000  # a plane byte
            b3 = ans_base(fl[3])
            bad[3, b3 + 136 + 5] ^= 0x10  # a lane's final state
            bad[2, ans_base(fl[2]) + 1] = 0xFFFF  # a block count past the row
            cases = {"as written": arcs, "odd stream starts": odd, "faults": bad,
                     "rows not 16-byte aligned": misaligned(bad)}
            for what, a in cases.items():
                require_exact(
                    f"decode ft={ft} pb={pb} lengths={fl}: {what}",
                    zip(cuda_decode.decode_float_batched_cuda(a, ft, Lw, pb, None, True),
                        cuda_decode.decode_float_batched_plain(a, ft, Lw, pb, None, True)))
            r = codec.float_decompress_batched(odd, ft, Lw, pb, True)
            valid = torch.arange(Lw, device=dev)[None, :] < torch.tensor(fl, device=dev)[:, None]
            require(bool(r["success"].all()) and bool(r["checksum_ok"].all())
                    and torch.equal(r["out32"].view(w.dtype), torch.where(valid, w, 0)),
                    f"float containers with odd stream starts decode to their words, ft={ft}")
    log("  decode (f16/bf16/f32): the same words and status as the plain version on every fault")


def encode_case(what, data, lengths, pb):
    """The encode kernel against its plain version on a (B, L) uint8 batch
    on the card, each member with the table of its own first lengths[m]
    bytes (`lengths` an int for every member, passed as one scalar, or B
    ints, passed on the card): staged words up to each block's count, the
    counts and the states, bit for bit. Returns the kernel's counts."""
    import torch

    from dietgpu_tpu_torch.ans import cuda_encode, cuda_hist, stats
    from dietgpu_tpu_torch.ans import encode as plain_encode

    B = data.shape[0]
    d32 = data.view(torch.int32)
    lens = [lengths] * B if isinstance(lengths, int) else list(lengths)
    hist, _ = cuda_hist.histogram_u8_batched_plain(d32, lens)
    totals = torch.tensor(lens, dtype=torch.int64, device=data.device)
    tables = plain_encode.encode_table(stats.normalize_probs(hist, totals, pb))
    n = lengths if isinstance(lengths, int) else totals
    ke = cuda_encode.encode_blocks_batched_cuda(d32, n, pb, tables)
    pe = plain_encode.encode_blocks_batched(d32, n, pb, tables)
    require_exact(f"encode {what} pb={pb}",
                  [(ke[1], pe[1]), (ke[2], pe[2])] + staged_pairs(ke[0], pe[0], ke[1]))
    return ke[1]


def phase2_slice6(port, dev):
    """The redesigned encode and f32 join kernels against their plain
    versions on the inputs their designs are at risk on, bit for bit. For
    encode: constant bytes (a symbol of probability 1, which emits
    nothing), two alternating values and uniform random bytes (the most
    emission) at prob_bits 9-11, a block that overflows 2560 words at
    prob_bits 11, lengths 1, 31, 33, 4095, 4096 and 4097 (alone and as one
    ragged batch), one-block members, a ragged batch whose members cross
    the persistent CTAs' shares, B = 1 and B = 513 (more members than one
    round of the kernel's member scan), and path C's 2^28 bytes. For the f32
    join: low-plane rows that are not 8-byte aligned, exponent and high
    rows that are not 16-byte aligned, an n4 that is not a multiple of 4,
    and a batch."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch.floatcodec import cuda_float

    gen = torch.Generator(device=dev).manual_seed(6)
    Lb = 1 << 20
    fills = {
        "constant": torch.zeros((1, Lb), dtype=torch.uint8, device=dev),
        "alternating": torch.tensor([0x01, 0xFE], dtype=torch.uint8,
                                    device=dev).repeat(Lb // 2)[None],
        "uniform": torch.randint(0, 256, (1, Lb), dtype=torch.uint8, device=dev, generator=gen),
    }
    for name, d in fills.items():
        for pb in (9, 10, 11):
            counts = encode_case(f"{name} bytes, {Lb} bytes", d, Lb, pb)
            if name == "constant":
                require(int(counts.max()) == 0, "constant bytes emitted words")
    rare = torch.arange(1, 256, dtype=torch.uint8, device=dev).repeat(17)[:4096]
    ovf = torch.cat([torch.zeros(16 * 4096, dtype=torch.uint8, device=dev), rare])[None]
    counts = encode_case("overflow block", ovf, ovf.shape[1], 11)
    require(int(counts.max()) > 2560, "the overflow input did not overflow")

    short = [1, 31, 33, 4095, 4096, 4097]
    d = torch.randint(0, 256, (len(short), 2 * 4096), dtype=torch.uint8, device=dev,
                      generator=gen)
    for n in short:
        encode_case(f"length {n}", d[:1], n, 10)
    encode_case(f"lengths {short}", d, short, 10)

    rng = np.random.default_rng(6)

    def ragged(B, nb, empty):
        lens = rng.integers(1, nb * 4096 + 1, B)
        lens[rng.random(B) < empty] = 0
        data = np.minimum(rng.exponential(20, (B, nb * 4096)), 255).astype(np.uint8)
        return torch.from_numpy(data).to(dev), lens.tolist()

    data, lens = ragged(64, 1, 0.0)
    encode_case("64 one-block members", data, lens, 10)
    data, lens = ragged(37, 64, 0.2)  # ~1200 live blocks: shares of a few blocks a CTA
    for pb in (9, 10, 11):
        encode_case(f"{len(lens)} ragged members of up to 64 blocks", data, lens, pb)
    data, lens = ragged(513, 2, 0.3)
    encode_case("513 members", data, lens, 10)
    encode_case("513 members of one length", data, 5000, 10)
    data, lens = ragged(1, 3, 0.0)
    encode_case("B = 1, a ragged length", data, lens, 10)
    del data, d, fills, ovf

    L = RAW_BYTES
    dc = torch.empty(L, device=dev).exponential_(1 / 30, generator=gen).clamp_(max=255)
    encode_case(f"{L} exponential bytes (path C's size)", dc.to(torch.uint8)[None], L, 10)
    del dc
    torch.cuda.empty_cache()

    def rand(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    for B, n4 in ((1, 12345), (5, 12345), (3, 1 << 16)):
        e, lo, h = rand(B, n4 + 3), rand(B, 2 * n4 + 3), rand(B, n4 + 3)
        # (exponent and high offset, low offset, low stride), in u32: the
        # rows as allocated, a low plane 4 bytes past an 8-byte boundary, an
        # odd low stride, and every plane off its alignment
        for eo, lo_off, lo_stride in ((0, 0, 2 * n4), (0, 1, 2 * n4), (0, 0, 2 * n4 + 1),
                                      (1, 1, 2 * n4 + 1), (3, 2, 2 * n4)):
            lv = lo.view(-1)[lo_off : lo_off + B * lo_stride].view(B, lo_stride)[:, : 2 * n4]
            ev, hv = e[:, eo : eo + n4], h[:, eo : eo + n4]
            require_exact(f"join_f32 B={B} n4={n4} exp/high offset {eo}, low offset "
                          f"{lo_off} stride {lo_stride}",
                          [(cuda_float.join_words_f32_cuda(ev, lv, hv),
                            cuda_float.join_words_f32_plain(ev, lv, hv))])
    log("  encode and join_f32: the same outputs as the plain versions on every input")


BIG_BATCH = 65537  # members: one more than a launch's grid y holds


def big_batch_split(dev):
    """The split kernel at BIG_BATCH ragged members of up to 4096 uniformly
    random words (more than 256 rounds of its member scan), five members
    held against the plain version."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import cuda_float

    lens = np.random.default_rng(65537).integers(0, 4097, BIG_BATCH).tolist()
    w = torch.randint(-(1 << 31), 1 << 31, (BIG_BATCH, 2048), dtype=torch.int32, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(72))
    got = cuda_float.split_words_batched_cuda(w, lens, C.FLOAT_TYPE_BFLOAT16, True)
    for m in (0, 1, BIG_BATCH // 2, BIG_BATCH - 2, BIG_BATCH - 1):
        require_exact(f"split at {BIG_BATCH} ragged members, member {m}", zip(
            (x[m] for x in got),
            cuda_float.split_words_plain(w[m], lens[m], C.FLOAT_TYPE_BFLOAT16, True)))


def big_batch_float(port, dev, ft):
    """BIG_BATCH members of 4096 words (standard normal) through
    float_compress_batched and float_decompress_batched: the roundtrip is
    exact, and the archives of members 0, 65535 and 65536 equal their
    single-tensor archives."""
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import codec

    n = C.DEFAULT_BLOCK_SIZE
    x = torch.randn((BIG_BATCH, n), generator=torch.Generator(device=dev).manual_seed(ft),
                    device=dev)
    w = x.view(torch.int32) if ft == C.FLOAT_TYPE_FLOAT32 else (x.view(torch.int32) >> 16).to(
        torch.int16)
    del x
    arcs, sizes = port.float_compress_batched(w, n, ft, 10, False)
    res = port.float_decompress_batched(arcs, ft, n, 10, False, static_length=n)
    require(bool(res["success"].all()), f"{BIG_BATCH} members ft={ft}: decode failed its status")
    require(torch.equal(res["out32"], w.view(torch.int32)),
            f"{BIG_BATCH} members ft={ft}: roundtrip differs")
    del res
    for m in (0, BIG_BATCH - 2, BIG_BATCH - 1):
        a, s = codec.float_compress_padded(w[m], n, ft, 10, False)
        require_exact(f"{BIG_BATCH} members ft={ft}: member {m}'s archive vs its single-tensor "
                      "archive", [(sizes[m], s), (arcs[m, : int(s) // 4], a[: int(s) // 4])])


def big_batch_joins(port, dev):
    """join_words_packed and join_words_packed_f32 at BIG_BATCH members of
    1024 exponent u32: members 0 and 65536 equal their plain joins."""
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import cuda_float

    g = torch.Generator(device=dev).manual_seed(5)

    def rand(width):
        return torch.randint(-(1 << 31), 1 << 31, (BIG_BATCH, width), dtype=torch.int32,
                             device=dev, generator=g)

    n4 = 1024
    e, c, lo, hi = rand(n4), rand(n4), rand(2 * n4), rand(n4)
    rows = [0, BIG_BATCH - 1]
    ft = C.FLOAT_TYPE_BFLOAT16
    require_exact(f"join at {BIG_BATCH} members, members {rows}",
                  [(port.join_words_packed(e, c, ft)[rows],
                    cuda_float.join_words_plain(e[rows], c[rows], ft))])
    require_exact(f"join_f32 at {BIG_BATCH} members, members {rows}",
                  [(port.join_words_packed_f32(e, lo, hi)[rows],
                    cuda_float.join_words_f32_plain(e[rows], lo[rows], hi[rows]))])


def phase2_slice7(port, dev):
    """The redesigned split kernel against its plain version, bit for bit
    (planes, histogram, checksum), on the inputs its design is at risk on:
    constant words, alternating exponents and uniformly random words (every
    exponent byte) at member lengths 0, 1, 7, 8, 9, 4095, 4096, 4097 and
    Lw, alone and as one ragged batch; nonComp rows 8 bytes past a 16-byte
    boundary; ragged batches whose members cross the persistent CTAs'
    shares; B = 513 (more than one round of the member scan); uniformly
    random words at path A's 128Mi (path A's normal words are held in phase
    3). The pairs' rows must be 16-byte aligned (the wrapper rejects
    others). Then batches of 65537 members, one more than a launch's grid y
    holds: ragged through the split, and through the compress and
    decompress kernels in bf16 and f32 and through both joins."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import _build
    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import cuda_float

    log(f"  resources of split: {_build.kernel_resources('split')}")
    gen = torch.Generator(device=dev).manual_seed(71)
    Lw = 4 * C.DEFAULT_BLOCK_SIZE
    edges = [0, 1, 7, 8, 9, 4095, 4096, 4097, Lw]
    B = len(edges)

    def case(what, pairs, lengths, ft, ck=True, nc_out=None, nc_plain=None):
        require_exact(what, zip(
            cuda_float.split_words_batched_cuda(pairs, lengths, ft, ck, nc_out),
            cuda_float.split_words_batched_plain(pairs, lengths, ft, ck, nc_plain)))

    for ft in (C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16):
        one = 0x3F80 if ft == C.FLOAT_TYPE_BFLOAT16 else 0x3C00  # 1.0
        big = 0x4780 if ft == C.FLOAT_TYPE_BFLOAT16 else 0x7800  # 65536 or 32768
        fills = {
            "constant": torch.full((B, Lw), one, dtype=torch.int16, device=dev),
            "alternating exponents": torch.tensor([one, big], dtype=torch.int32, device=dev)
            .repeat(B * Lw // 2).view(B, Lw).to(torch.int16),
            "uniform": torch.randint(-(1 << 15), 1 << 15, (B, Lw), dtype=torch.int16,
                                     device=dev, generator=gen),
        }
        for name, w in fills.items():
            pairs = w.view(torch.int32)
            for n in edges:
                for ck in (False, True):
                    case(f"split ft={ft} {name} n={n} ck={ck}", pairs[:1], n, ft, ck)
            case(f"split ft={ft} {name} lengths={edges}", pairs, edges, ft)
            wide = torch.full((B, Lw // 4 + 4), -1, dtype=torch.int32, device=dev)
            plain = wide.clone()
            case(f"split ft={ft} {name} lengths={edges}, nonComp rows 8 bytes past 16",
                 pairs, edges, ft, True, wide[:, 2 : 2 + Lw // 4], plain[:, 2 : 2 + Lw // 4])
        rng = np.random.default_rng(7 + ft)
        for Bm, blocks in ((37, 64), (513, 2), (3, 1)):
            w = torch.randint(-(1 << 31), 1 << 31, (Bm, blocks * 2048), dtype=torch.int32,
                              device=dev, generator=gen)
            lens = rng.integers(0, blocks * 4096 + 1, Bm)
            lens[rng.random(Bm) < 0.2] = 0
            case(f"split ft={ft} {Bm} ragged members of up to {blocks} blocks", w,
                 lens.tolist(), ft)
            case(f"split ft={ft} {Bm} members of one length", w, blocks * 4096 - 3, ft)
    n = MWORDS << 20
    w = torch.randint(-(1 << 31), 1 << 31, (1, n // 2), dtype=torch.int32, device=dev,
                      generator=gen)
    case(f"split bf16 {n} uniform words (path A's size)", w, n, C.FLOAT_TYPE_BFLOAT16, False)
    del w
    torch.cuda.empty_cache()

    log(f"  {BIG_BATCH} members: the ragged split, compress, decompress and joins")
    big_batch_split(dev)
    torch.cuda.empty_cache()
    for ft in (C.FLOAT_TYPE_BFLOAT16, C.FLOAT_TYPE_FLOAT32):
        big_batch_float(port, dev, ft)
        torch.cuda.empty_cache()
    big_batch_joins(port, dev)
    torch.cuda.empty_cache()
    log("  split: the same outputs as the plain version on every input; "
        f"{BIG_BATCH} members round-trip and join")


def uniform_words(dev, shape, seed):
    """int32 words drawn uniformly (every exponent byte), from a seed."""
    import torch

    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))


def phase2_slice10(port, dev):
    """The redesigned split_f32 kernel against its plain version, bit for bit
    (planes, histogram, checksum), on the inputs its design is at risk on:
    constant words (one exponent), alternating exponents and uniformly
    random words at member lengths 0-17 around each quad and 16-word group,
    4095-4097 and Lw, alone with and without the checksum and as one ragged
    batch; container mode into rows that start 8 bytes past a 16-byte
    boundary, prefilled with -1, which must survive past each member's
    archived ends; ragged batches whose members cross the CTAs' shares;
    B = 513; uniformly random words at path B's 128Mi. Returns the max
    abs error of the last (the split_f32_uniform row's)."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import _build
    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import cuda_float

    log(f"  resources of split_f32: {_build.kernel_resources('split_f32')}")
    gen = torch.Generator(device=dev).manual_seed(101)
    Lw = 4 * C.DEFAULT_BLOCK_SIZE
    edges = [0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 4095, 4096, 4097, Lw]
    B = len(edges)

    def case(what, words, lengths, ck=True):
        return require_exact(what, zip(
            cuda_float.split_words_f32_batched_cuda(words, lengths, ck),
            cuda_float.split_words_f32_batched_plain(words, lengths, ck)))

    def container_case(what, words, lengths, ck=True):
        Bm, W = words.shape
        lengths = lengths if isinstance(lengths, list) else [lengths] * Bm
        wide = torch.full((Bm, 3 * W // 4 + 8), -1, dtype=torch.int32, device=dev)
        plain = wide.clone()
        rows = slice(2, 2 + 3 * W // 4)
        got = cuda_float.split_words_f32_batched_cuda(words, lengths, ck, wide[:, rows])
        want = cuda_float.split_words_f32_batched_plain(words, lengths, ck, plain[:, rows])
        require_exact(what, [(got[i], want[i]) for i in (0, 3, 4)] + [(wide, plain)])
        for m, n in enumerate(lengths):  # past the archived ends, nothing written
            end = 2 + C.round_up(n, 8) // 2 + C.round_up(n, 16) // 4
            require(bool((wide[m, end:] == -1).all()) and bool((wide[m, :2] == -1).all()),
                    f"{what}: member {m} (n={n}) wrote past its archived ends")

    one, big = 0x3F800000, 0x47800000  # 1.0 and 65536.0
    fills = {
        "constant": torch.full((B, Lw), one, dtype=torch.int32, device=dev),
        "alternating exponents": torch.tensor([one, big], dtype=torch.int32, device=dev)
        .repeat(B * Lw // 2).view(B, Lw),
        "uniform": torch.randint(-(1 << 31), 1 << 31, (B, Lw), dtype=torch.int32, device=dev,
                                 generator=gen),
    }
    for name, w in fills.items():
        for n in edges:
            for ck in (False, True):
                case(f"split_f32 {name} n={n} ck={ck}", w[:1], n, ck)
        for ck in (False, True):
            case(f"split_f32 {name} lengths={edges} ck={ck}", w, edges, ck)
            container_case(f"split_f32 {name} lengths={edges} ck={ck}, container rows 8 bytes "
                           "past 16, prefilled with -1", w, edges, ck)
    rng = np.random.default_rng(10)
    for Bm, blocks in ((37, 64), (513, 2), (3, 1)):
        w = torch.randint(-(1 << 31), 1 << 31, (Bm, blocks * 4096), dtype=torch.int32,
                          device=dev, generator=gen)
        lens = rng.integers(0, blocks * 4096 + 1, Bm)
        lens[rng.random(Bm) < 0.2] = 0
        lens = lens.tolist()
        case(f"split_f32 {Bm} ragged members of up to {blocks} blocks", w, lens)
        container_case(f"split_f32 {Bm} ragged members of up to {blocks} blocks, container",
                       w, lens)
        case(f"split_f32 {Bm} members of one length", w, blocks * 4096 - 3)
        container_case(f"split_f32 {Bm} members of one length, container", w, blocks * 4096 - 3)
    del fills, w
    n = MWORDS << 20
    w = uniform_words(dev, (1, n), 10)
    err = case(f"split_f32 {n} uniform words (path B's size)", w, n, False)
    del w
    torch.cuda.empty_cache()
    log("  split_f32: the same outputs as the plain version on every input")
    return err


def float_batch_path(port, name, ft, words, err):
    """Path D or E: a (B, ...) batch of MEMBER_WORDS words per member
    through float_compress_batched / float_decompress_batched. Fills err
    with the path's kernels' errors against their plain versions at these
    shapes; returns what phase 4 times."""
    import torch

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.ans import cuda_decode, cuda_encode, stats
    from dietgpu_tpu_torch.ans import encode as plain_encode
    from dietgpu_tpu_torch.floatcodec import codec, cuda_float

    B = words.shape[0]
    n = Lw = MEMBER_WORDS
    f32 = ft == C.FLOAT_TYPE_FLOAT32
    want = words.view(torch.int32)

    def run():
        a, s = port.float_compress_batched(words, n, ft, 10, False)
        return a, s, port.float_decompress_batched(a, ft, Lw, 10, False, static_length=n)

    (arcs, sizes, res), launches = drive(port, name, run)
    require(bool(res["success"].all()) and bool((res["size"] == n).all()),
            f"path {name} decode failed its status")
    require(torch.equal(res["out32"], want), f"path {name} roundtrip differs")
    log(f"  roundtrip exact for all {B} members")
    pa, ps = codec.float_compress_batched_plain(words, n, ft, 10, False)
    require_exact(f"path {name} archives vs the batched plain pipeline",
                  member_pairs(arcs, sizes, pa, ps))
    del pa, ps
    single = [codec.float_compress_padded(words[m], n, ft, 10, False) for m in range(B)]
    require_exact(f"path {name} archives vs {B} single-tensor kernel calls",
                  member_pairs(arcs, sizes, torch.stack([a for a, _ in single]),
                               torch.stack([s for _, s in single])))
    a2, _ = port.float_compress_batched(words, n, ft, 10, True)
    r2 = port.float_decompress_batched(a2, ft, Lw, 10, True, static_length=n)
    require(bool(r2["success"].all()) and bool(r2["checksum_ok"].all())
            and torch.equal(r2["out32"], want), f"path {name} checksummed call failed")
    log("  checksummed call: roundtrip exact, checksum verified on decode")
    del a2, r2

    split_k = "split_f32_batched" if f32 else "split_batched"
    split_cuda = cuda_float.split_words_f32_batched_cuda if f32 else cuda_float.split_words_batched_cuda
    split_plain = (cuda_float.split_words_f32_batched_plain if f32
                   else cuda_float.split_words_batched_plain)
    split_args = (words, n) if f32 else (words, n, ft)
    ks = split_cuda(*split_args)
    err[split_k] = require_exact(f"{split_k}, path {name} shape",
                                 zip(ks, split_plain(*split_args)))
    dec_k = "decode_f32_batched" if f32 else "decode_batched"
    snb = cuda_decode.static_block_count(n, Lw)
    e = 0
    for digest in (False, True):
        e = max(e, require_exact(
            f"{dec_k} digest={digest}, path {name} shape",
            zip(cuda_decode.decode_float_batched_cuda(arcs, ft, Lw, 10, n, digest, snb),
                cuda_decode.decode_float_batched_plain(arcs, ft, Lw, 10, n, digest, snb)),
        ))
    err[dec_k] = e
    state = {
        "arcs": arcs, "sizes": sizes, "launches": launches, "single": [a for a, _ in single],
        "split": (lambda: split_cuda(*split_args), lambda: split_plain(*split_args)),
        "decode": (lambda: cuda_decode.decode_float_batched_cuda(arcs, ft, Lw, 10, n, False, snb),
                   lambda: cuda_decode.decode_float_batched_plain(arcs, ft, Lw, 10, n, False,
                                                                  snb)),
    }
    if not f32:
        # the encode and assembly kernels at path D's shapes
        exp32 = ks[0]
        pdfs = stats.normalize_probs(ks[2], n, 10)
        tables = plain_encode.encode_table(pdfs)
        ke = cuda_encode.encode_blocks_batched_cuda(exp32, n, 10, tables)
        pe = plain_encode.encode_blocks_batched(exp32, n, 10, tables)
        err["encode_batched"] = require_exact(
            f"encode_batched, path {name} shape",
            [(ke[1], pe[1]), (ke[2], pe[2])] + staged_pairs(ke[0], pe[0], ke[1]))
        del pe
        base32 = 4 + C.round_up(n, 16) // 4
        asm_k = torch.zeros_like(arcs)
        prefix, ds32, _, _ = plain_encode.write_sections_batched(
            asm_k, base32, pdfs, ke[2], ke[1], [n] * B, 10)
        ds = ds32[0]  # one payload offset for every member, as the path passes it
        asm_p = asm_k.clone()
        cuda_encode.assemble_payload_batched_cuda(asm_k, ds, ke[0], ke[1], prefix)
        plain_encode.assemble_payload_batched(asm_p, ds, ke[0], ke[1], prefix)
        err["assembly_batched"] = require_exact(f"assembly_batched, path {name} shape",
                                                [(asm_k, asm_p)])
        del asm_p
        counts = ke[1].long()
        state["encode"] = (
            lambda: cuda_encode.encode_blocks_batched_cuda(exp32, n, 10, tables),
            lambda: plain_encode.encode_blocks_batched(exp32, n, 10, tables))
        state["assembly"] = (
            lambda: cuda_encode.assemble_payload_batched_cuda(asm_k, ds, ke[0], ke[1], prefix),
            lambda: plain_encode.assemble_payload_batched(asm_k, ds, ke[0], ke[1], prefix))
        state["emitted"] = int(counts.sum())
        state["padded_words"] = int(((counts + 7) // 8 * 8).clamp(max=2560).sum())
    torch.cuda.empty_cache()
    return state


def raw_batch_path(port, data, lengths, err):
    """Path F: RAW_MEMBERS members of ragged lengths through
    ans_encode_batched / ans_decode_batched. Fills err for hist_batched and
    decode_raw_batched; returns what phase 4 times."""
    import torch

    from dietgpu_tpu_torch.ans import cuda_decode, cuda_encode, cuda_hist

    B, L = data.shape

    def run():
        a, s = port.ans_encode_batched(data, lengths, None, 10, False)
        return a, s, port.ans_decode_batched(a, 10, L)

    (arcs, sizes, res), launches = drive(port, "F", run)
    require(bool(res["success"].all()) and res["size"].tolist() == lengths,
            "path F decode failed its status")
    require(torch.equal(res["out"], data), "path F roundtrip differs")
    log(f"  roundtrip exact for all {B} members")
    for pb in (10, 9, 11):
        if pb == 10:
            a, s = arcs, sizes
        else:
            a, s = port.ans_encode_batched(data, lengths, None, pb, False)
            r = port.ans_decode_batched(a, pb, L)
            require(bool(r["success"].all()) and torch.equal(r["out"], data),
                    f"path F roundtrip differs at pb {pb}")
        pa, ps = cuda_encode.ans_encode_batched_plain(data, lengths, None, pb, False)
        require_exact(f"path F archives vs the batched plain pipeline, pb {pb}",
                      member_pairs(a, s, pa, ps))
        del pa, ps
    single = [port.ans_encode_padded(data[m], n, 10, False) for m, n in enumerate(lengths)]
    require_exact(f"path F archives vs {B} single-tensor kernel calls",
                  member_pairs(arcs, sizes, torch.stack([a for a, _ in single]),
                               torch.stack([s for _, s in single])))
    a2, _ = port.ans_encode_batched(data, lengths, None, 10, True)
    r2 = port.ans_decode_batched(a2, 10, L, verify_checksum=True)
    require(bool(r2["success"].all()) and bool(r2["checksum_ok"].all())
            and torch.equal(r2["out"], data), "path F checksummed call failed")
    log("  checksummed call: roundtrip exact, checksum verified on decode")
    del a2, r2
    d32 = data.view(torch.int32)
    lengths_t = torch.tensor(lengths, dtype=torch.int64, device=data.device)
    err["hist_batched"] = require_exact(
        "hist_batched ck=True, path F shape",
        zip(cuda_hist.histogram_u8_batched_cuda(d32, lengths, True),
            cuda_hist.histogram_u8_batched_plain(d32, lengths, True)))
    e = 0
    for digest in (False, True):
        e = max(e, require_exact(
            f"decode_raw_batched digest={digest}, path F shape",
            zip(cuda_decode.decode_raw_batched_cuda(arcs, 10, L, None, digest),
                cuda_decode.decode_raw_batched_plain(arcs, 10, L, None, digest))))
    err["decode_raw_batched"] = e
    torch.cuda.empty_cache()
    return {
        "arcs": arcs, "sizes": sizes, "launches": launches, "single": [a for a, _ in single],
        # as ans_encode_batched calls it: the lengths on the card, made once
        "hist": (lambda: cuda_hist.histogram_u8_batched_cuda(d32, lengths, False, lengths_t),
                 lambda: cuda_hist.histogram_u8_batched_plain(d32, lengths)),
        "decode": (lambda: cuda_decode.decode_raw_batched_cuda(arcs, 10, L),
                   lambda: cuda_decode.decode_raw_batched_plain(arcs, 10, L)),
    }


def member_decode_phase(port, arc, size, n, Lw, ft, dev, err):
    """Path M: the decode kernel's descriptor form, each archive read where
    it lies and each member written into its destination, as
    ``torch_api.decompress_data`` runs it in place: at path A's shape
    (kHalf, A's exact archive into a bf16 tensor of n words) and at one
    DeepSeek-V3 EP32 expert layer's (kRaw, EXPERTS e4m3 bytes of N(0,
    100^2), as a 128x128 block scale leaves weights, each archive a row of
    the compress buffer, decoded at the API's width into a tensor of its
    own), beside the strided form at the same width (the archives staged
    into zero-filled rows). Each form is held bit for bit against the
    input, the other form and the plain version, and launches the kernel
    once. Fills err; returns the rows' runs, work and the launches each
    row's call was counted making."""
    import torch

    from dietgpu_tpu_torch import api
    from dietgpu_tpu_torch.ans import cuda_decode
    from dietgpu_tpu_torch.ans import encode as ans_encode

    def once(fn, kernel):
        """fn's result, having held that it launched `kernel` once and
        nothing else, and the counts it made."""
        torch.cuda.synchronize()
        port.reset_kernel_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in port.kernel_launches().items() if v}
        require(got == {kernel: 1}, f"path M launches {got}, not one {kernel}")
        return out, got

    # kHalf at path A's shape
    arc_a = arc[: size // 4]
    dest = torch.empty(n, dtype=torch.bfloat16, device=dev)
    dest_p = torch.empty_like(dest)
    members_a = (lambda: cuda_decode.decode_members([arc_a], arc.numel(), Lw, 10, ft, [dest]))
    plain_a = (lambda: cuda_decode._members_plain([arc_a], arc.numel(), Lw, 10, ft, [dest_p]))
    (_, st), got_a = once(members_a, "decode")
    ok, sz, _ = cuda_decode.status_fields(st)
    strided = cuda_decode.decode_float_batched_cuda(arc[None], ft, Lw, 10)
    want_a = strided[0][0].view(torch.int16)[:n]
    require(bool(ok.all()) and sz.tolist() == [n] and bool(strided[1].all()),
            "path M kHalf status")
    _, st_p = plain_a()
    err["decode_members"] = require_exact(
        "decode_members (kHalf), path A shape",
        [(dest.view(torch.int16), want_a), (dest_p.view(torch.int16), want_a), (st, st_p)])
    del strided, want_a

    # kRaw at one expert layer's shape
    XM, XB = EXPERTS
    gen = torch.Generator(device=dev).manual_seed(19)
    data = (torch.randn((XM, XB), generator=gen, device=dev) * 100).clamp(-448, 448)
    data = data.to(torch.float8_e4m3fn).view(torch.uint8)
    arcs, sizes = port.ans_encode_batched(data, [XB] * XM, None, 10, False)
    Lx = api._bucket_words(XB)
    a32 = ans_encode.archive_buffer_bytes(Lx) // 4
    staged = torch.zeros((XM, a32), dtype=torch.int32, device=dev)
    staged[:, : arcs.shape[1]] = arcs
    archives = list(arcs.unbind(0))
    dests = [torch.empty(XB, dtype=torch.uint8, device=dev) for _ in range(XM)]
    dests_p = [torch.empty_like(d) for d in dests]
    strided_x = (lambda: cuda_decode.decode_raw_batched_cuda(staged, 10, Lx))
    members_x = (lambda: cuda_decode.decode_members(archives, a32, Lx, 10, None, dests))
    (out_s, ok_s, sz_s, _), got_s = once(strided_x, "decode_raw")
    (_, st_m), got_m = once(members_x, "decode_raw")
    ok_m, sz_m, _ = cuda_decode.status_fields(st_m)
    require(bool(ok_s.all()) and bool(ok_m.all()) and sz_m.tolist() == [XB] * XM,
            "path M kRaw status")
    require(torch.equal(out_s.view(torch.uint8)[:, :XB], data), "path M strided kRaw differs")
    require(all(torch.equal(d, x) for d, x in zip(dests, data)), "path M kRaw differs")
    log(f"  path M: {XM} members of {XB} e4m3 bytes, ratio "
        f"{int(sizes.sum()) / (XM * XB):.6f}, decoded by both forms bit for bit")
    plain_s = cuda_decode.decode_raw_batched_plain(staged, 10, Lx)
    err["decode_raw_experts"] = require_exact(
        "decode_raw_experts (strided), path M shape",
        [(out_s, plain_s[0]), (ok_s, plain_s[1]), (sz_s, plain_s[2])])
    del out_s, plain_s
    torch.cuda.empty_cache()
    _, st_p = cuda_decode._members_plain(archives, a32, Lx, 10, None, dests_p)
    err["decode_raw_members"] = require_exact(
        "decode_raw_members, path M shape", [(torch.stack(dests), torch.stack(dests_p)),
                                             (st_m, st_p)])
    del dests_p
    torch.cuda.empty_cache()
    arc_bytes = int(sizes.sum())
    return {
        "launches": {"decode_members": got_a, "decode_raw_experts": got_s,
                     "decode_raw_members": got_m},
        "work": {"decode_members": (size + 2 * n, n),
                 "decode_raw_experts": (arc_bytes + XM * XB, XM * XB),
                 "decode_raw_members": (arc_bytes + XM * XB, XM * XB)},
        "runs": {"decode_members": (members_a, plain_a),
                 "decode_raw_experts": (strided_x, lambda: cuda_decode.decode_raw_batched_plain(
                     staged, 10, Lx)),
                 "decode_raw_members": (members_x, lambda: cuda_decode._members_plain(
                     archives, a32, Lx, 10, None, [torch.empty_like(d) for d in dests]))},
    }


def api_paths(port, bat, words_d, data_f, lengths_f, err):
    """Paths G, H and Hr through the API. Fills err for split_ragged;
    returns what phase 4 times."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import api, torch_api
    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import codec, cuda_float

    BF16 = C.FLOAT_TYPE_BFLOAT16
    dev = words_d.device

    def rows(comp, sizes):
        return [comp[b, :s] for b, s in enumerate(sizes.tolist())]

    def same_archives(what, comp, sizes, arcs32, ref_sizes):
        require(sizes.tolist() == layout_i32(ref_sizes).tolist(), f"{what}: sizes differ")
        ref = arcs32.view(torch.uint8)
        require_exact(what, [(comp[b, :s], ref[b, :s]) for b, s in enumerate(sizes.tolist())])

    def layout_i32(t):
        return torch.where(t >= 1 << 31, t - (1 << 32), t)

    # ---- path G: path D's members as 128 tensors through torch_api ----
    log(f"# phase 3: path G, {BATCH} bf16 tensors of {MEMBER_WORDS} words through torch_api")
    ts_g = [words_d[m].view(torch.bfloat16) for m in range(BATCH)]
    outs_g = [torch.empty_like(t) for t in ts_g]

    def run_g():
        comp, sizes, _ = torch_api.compress_data(True, ts_g)
        st, osz, _ = torch_api.decompress_data(True, rows(comp, sizes), outs_g)
        return comp, sizes, st, osz

    (comp_g, sizes_g, st, osz), launches_g = drive(port, "G", run_g)
    require(st.tolist() == [1] * BATCH and osz.tolist() == [2 * MEMBER_WORDS] * BATCH,
            "path G decompress failed its status")
    require(all(torch.equal(o, t) for o, t in zip(outs_g, ts_g)), "path G roundtrip differs")
    same_archives("path G archives vs path D's", comp_g, sizes_g, bat["D"]["arcs"],
                  bat["D"]["sizes"])

    # ---- path H: 64 ragged bf16 tensors through api ----
    rng = np.random.default_rng(0)
    lens_h = rng.integers(RAGGED_WORDS[0], RAGGED_WORDS[1] + 1, RAGGED_MEMBERS).tolist()
    ts_h = []
    for n in lens_h:
        x = rng.standard_normal(n).astype(np.float32)
        w = (x.view(np.uint32) >> 16).astype(np.uint16).view(np.int16)
        ts_h.append(torch.from_numpy(w).to(dev).view(torch.bfloat16))
    del x, w
    log(f"# phase 3: path H, {RAGGED_MEMBERS} bf16 tensors of {sum(lens_h)} words in "
        f"[{RAGGED_WORDS[0]}, {RAGGED_WORDS[1]}] through api")

    def run_h():
        comp, sizes, _ = api.compress_data(True, ts_h)
        outs, st, osz, _ = api.decompress_data(True, rows(comp, sizes), ts_h)
        return comp, sizes, outs, st, osz

    (comp_h, sizes_h, outs, st, osz), launches_h = drive(port, "H", run_h)
    require(st.tolist() == [1] * RAGGED_MEMBERS and osz.tolist() == [2 * n for n in lens_h],
            "path H decompress failed its status")
    require(all(torch.equal(o, t) for o, t in zip(outs, ts_h)), "path H roundtrip differs")
    del outs
    single = []
    for t, n in zip(ts_h, lens_h):
        w = torch.zeros(C.round_up(n, C.DEFAULT_BLOCK_SIZE), dtype=torch.int16, device=dev)
        w[:n] = t.view(torch.int16)
        a, size = codec.float_compress_padded(w, n, BF16)
        single.append(a[: int(size) // 4].view(torch.uint8))
    require(sizes_h.tolist() == [a.numel() for a in single], "path H sizes differ")
    require_exact(f"path H archives vs {RAGGED_MEMBERS} single-tensor kernel calls",
                  [(comp_h[b, :s], single[b]) for b, s in enumerate(sizes_h.tolist())])
    del single
    padded = torch.zeros((RAGGED_MEMBERS, member_width(lens_h)), dtype=torch.int16, device=dev)
    for m, t in enumerate(ts_h):
        padded[m, : lens_h[m]] = t.view(torch.int16)
    pairs_h = padded.view(torch.int32)
    del padded
    # the lengths on the card, made once, as float_compress_batched passes them
    lens_t = torch.tensor(lens_h, dtype=torch.int64, device=dev)
    err["split_ragged"] = require_exact(
        "split_ragged, path H shape",
        zip(cuda_float.split_words_batched_cuda(pairs_h, lens_h, BF16, lengths_t=lens_t),
            cuda_float.split_words_batched_plain(pairs_h, lens_h, BF16)))

    # ---- path Hr: path F's members through api ----
    ts_r = [data_f[m, :n] for m, n in enumerate(lengths_f)]
    log(f"# phase 3: path Hr, path F's {len(ts_r)} raw members through api")

    def run_hr():
        comp, sizes, _ = api.compress_data(False, ts_r)
        outs, st, osz, _ = api.decompress_data(False, rows(comp, sizes), ts_r)
        return comp, sizes, outs, st, osz

    (comp_r, sizes_r, outs, st, osz), launches_r = drive(port, "Hr", run_hr)
    require(st.tolist() == [1] * len(ts_r) and osz.tolist() == lengths_f,
            "path Hr decompress failed its status")
    require(all(torch.equal(o, t) for o, t in zip(outs, ts_r)), "path Hr roundtrip differs")
    del outs
    same_archives("path Hr archives vs path F's", comp_r, sizes_r, bat["F"]["arcs"],
                  bat["F"]["sizes"])
    torch.cuda.empty_cache()
    return {
        "G": (ts_g, outs_g, comp_g, sizes_g, launches_g),
        "H": (ts_h, lens_h, comp_h, sizes_h, launches_h),
        "Hr": (ts_r, comp_r, sizes_r, launches_r),
        "split": (lambda: cuda_float.split_words_batched_cuda(pairs_h, lens_h, BF16,
                                                              lengths_t=lens_t),
                  lambda: cuda_float.split_words_batched_plain(pairs_h, lens_h, BF16)),
    }


def ragged_f32_path(port, lens_h, dev, err):
    """Path Hf: path H's lengths as 64 ragged f32 tensors (standard normal,
    default_rng(1)) through api.compress_data / api.decompress_data: each
    kernel once per call, every output its input, every archive the
    member's single-tensor archive. Fills err for split_f32_ragged (the
    kernel in container mode, the lengths on the card, as the compress
    passes them); returns what phase 4 times."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch import api
    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import codec, cuda_float

    F32 = C.FLOAT_TYPE_FLOAT32
    rng = np.random.default_rng(1)
    ts = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev) for n in lens_h]
    log(f"# phase 3: path Hf, {len(ts)} f32 tensors of {sum(lens_h)} words (path H's lengths) "
        "through api")

    def run():
        comp, sizes, _ = api.compress_data(True, ts)
        rows = [comp[b, :s] for b, s in enumerate(sizes.tolist())]
        outs, st, osz, _ = api.decompress_data(True, rows, ts)
        return comp, sizes, outs, st, osz

    (comp, sizes, outs, st, osz), launches = drive(port, "Hf", run)
    require(st.tolist() == [1] * len(ts) and osz.tolist() == [4 * n for n in lens_h],
            "path Hf decompress failed its status")
    require(all(torch.equal(o, t) for o, t in zip(outs, ts)), "path Hf roundtrip differs")
    del outs
    single = []
    for t, n in zip(ts, lens_h):
        w = torch.zeros(C.round_up(n, C.DEFAULT_BLOCK_SIZE), dtype=torch.int32, device=dev)
        w[:n] = t.view(torch.int32)
        a, size = codec.float_compress_padded(w, n, F32)
        single.append(a[: int(size) // 4].view(torch.uint8))
    require(sizes.tolist() == [a.numel() for a in single], "path Hf sizes differ")
    require_exact(f"path Hf archives vs {len(ts)} single-tensor kernel calls",
                  [(comp[b, :s], single[b]) for b, s in enumerate(sizes.tolist())])
    del single, comp
    words = torch.zeros((len(ts), member_width(lens_h)), dtype=torch.int32, device=dev)
    for m, t in enumerate(ts):
        words[m, : lens_h[m]] = t.view(torch.int32)
    del ts
    lens_t = torch.tensor(lens_h, dtype=torch.int64, device=dev)
    R = codec.float_archive_buffer_bytes(F32, words.shape[1]) // 4
    arcs, plain = (torch.zeros((len(lens_h), R), dtype=torch.int32, device=dev) for _ in "kp")
    got = cuda_float.split_words_f32_batched_cuda(words, lens_h, False, arcs[:, 4:], lens_t)
    want = cuda_float.split_words_f32_batched_plain(words, lens_h, False, plain[:, 4:])
    err["split_f32_ragged"] = require_exact(
        "split_f32_ragged, path Hf shape, container mode",
        [(got[i], want[i]) for i in (0, 3, 4)] + [(arcs, plain)])
    del plain, got, want
    torch.cuda.empty_cache()
    return {
        "launches": launches, "words": words,
        "split": (lambda: cuda_float.split_words_f32_batched_cuda(words, lens_h, False,
                                                                  arcs[:, 4:], lens_t),
                  lambda: cuda_float.split_words_f32_batched_plain(words, lens_h, False,
                                                                   arcs[:, 4:])),
        "work": (4 * sum(lens_h) + len(lens_h) * (words.shape[1] + 4 * 256)
                 + sum(2 * C.round_up(n, 8) + C.round_up(n, 16) for n in lens_h),
                 sum(lens_h)),
    }


def launch_once(port, what, fn, kernels):
    """Run fn with the launch counters at 0: each kernel of `kernels` must
    launch exactly once in it, and no other kernel."""
    import torch

    torch.cuda.synchronize()
    port.reset_kernel_launches()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in port.kernel_launches().items() if v}
    log(f"  launches of {what}: {got}")
    require(got == {k: 1 for k in kernels}, f"{what}: launches {got}, want each of {kernels} once")
    return out


def front_end_forms(port, bat, gh, words_d, data_f, lengths_f, card):
    """Path Gs: the split, stride and info forms of both front-ends at path
    G's width (path D's 128 bf16 members of 512Ki words, here one flat
    tensor or the rows of one (128, 512Ki) tensor) and on path F's raw rows,
    each call launching each of its kernels once. Returns the timing rows,
    each beside path G's calls on the same words."""
    import torch

    from dietgpu_tpu_torch import api, torch_api
    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.floatcodec import codec

    BF16 = C.FLOAT_TYPE_BFLOAT16
    n, B, dev = MEMBER_WORDS, BATCH, words_d.device
    flat = words_d.view(torch.bfloat16).view(-1)
    splits = [n] * B
    compress_k, raw_k = ("split", *ENC), ("hist", *ENC)
    d_arcs, d_sizes = bat["D"]["arcs"].view(torch.uint8), bat["D"]["sizes"].tolist()
    fail = B - 3  # the member (split or row) whose archive is swapped for a larger one
    sentinel = -0x5556  # 0xAAAA

    def rows(comp, sizes):
        return [comp[b, :s] for b, s in enumerate(sizes.tolist())]

    def same_archives(what, comp, sizes, ref, ref_sizes):
        require(sizes.tolist() == list(ref_sizes), f"{what}: sizes differ")
        require_exact(what, [(comp[b, :s], ref[b][:s]) for b, s in enumerate(sizes.tolist())])

    def strided_t_out():
        side = math.isqrt(B * n)  # (8192, 8192).t(): every element, not contiguous
        require(side * side == B * n, "path Gs: the strided output must hold the batch")
        return torch.full((side, side), sentinel, dtype=torch.int16, device=dev).view(
            torch.bfloat16).t()

    log(f"# phase 3: path Gs, the split, stride and info forms of api and torch_api: "
        f"{B} x {n} bf16 words, path F's {len(lengths_f)} raw rows")
    # ---- split forms ----
    for front in (api, torch_api):
        comp, sizes, _ = launch_once(
            port, f"{front.__name__}.compress_data_split_size",
            lambda: front.compress_data_split_size(True, flat, splits), compress_k)
        same_archives(f"{front.__name__}.compress_data_split_size archives vs path D's",
                      comp, sizes, d_arcs, d_sizes)
    arcs = rows(comp, sizes)
    flat_out, st, sz, _ = launch_once(
        port, "api.decompress_data_split_size",
        lambda: api.decompress_data_split_size(True, arcs, flat, splits), ("decode",))
    require(st.tolist() == [1] * B and sz.tolist() == [2 * n] * B
            and torch.equal(flat_out.view(torch.int16), flat.view(torch.int16)),
            "api.decompress_data_split_size differs")
    outs = {"contiguous": torch.full_like(flat.view(torch.int16), sentinel).view(torch.bfloat16),
            "not contiguous": strided_t_out()}
    for kind, t_out in outs.items():
        st, sz, _ = launch_once(
            port, f"torch_api.decompress_data_split_size into a {kind} t_out",
            lambda: torch_api.decompress_data_split_size(True, arcs, t_out, splits), ("decode",))
        require(st.tolist() == [1] * B and sz.tolist() == [2 * n] * B
                and t_out.is_contiguous() == (kind == "contiguous")
                and torch.equal(t_out.view(torch.int16), flat.view(torch.int16).view(t_out.shape)),
                f"torch_api.decompress_data_split_size into a {kind} t_out differs")
        log(f"  decoded bits of the {kind} t_out equal the input's")
    big = api.compress_data_simple(True, [flat[: n + C.DEFAULT_BLOCK_SIZE]])[0]
    t_out = strided_t_out()
    st, sz, _ = launch_once(
        port, "torch_api.decompress_data_split_size with a failing member",
        lambda: torch_api.decompress_data_split_size(
            True, arcs[:fail] + [big] + arcs[fail + 1:], t_out, splits), ("decode",))
    require(st.tolist() == [1] * fail + [0] + [1] * (B - fail - 1)
            and sz[fail] == 2 * (n + C.DEFAULT_BLOCK_SIZE),
            "a failing member's status or size differs")
    require(bool((t_out.view(torch.int16) == sentinel).all()),
            "a split of t_out was written though a member failed")
    log(f"  member {fail} failed: status 0, all of t_out still the sentinel")
    del outs, t_out, flat_out

    # ---- stride forms: rows of 512Ki and 384Ki words; F's raw rows ----
    x2d = flat.view(B, n)
    lens = [n if b % 2 == 0 else 3 * n // 4 for b in range(B)]
    comp_s, sizes_s, _ = launch_once(port, "api.compress_data_stride",
                                     lambda: api.compress_data_stride(True, x2d, lens), compress_k)
    single, single_sizes = [], []
    for b, m in enumerate(lens):
        w = torch.zeros(C.round_up(m, C.DEFAULT_BLOCK_SIZE), dtype=torch.int16, device=dev)
        w[:m] = x2d[b, :m].view(torch.int16)
        a, size = codec.float_compress_padded(w, m, BF16)
        single.append(a.view(torch.uint8))
        single_sizes.append(int(size))
    same_archives(f"api.compress_data_stride archives vs {B} single-tensor kernel calls",
                  comp_s, sizes_s, single, single_sizes)
    del single
    rows_s = rows(comp_s, sizes_s)
    keep = torch.arange(n, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    want = torch.where(keep, x2d.view(torch.int16), 0)
    out2d, st, sz, _ = launch_once(
        port, "api.decompress_data_stride",
        lambda: api.decompress_data_stride(True, rows_s, B, n, torch.bfloat16, lens), ("decode",))
    require(st.tolist() == [1] * B and sz.tolist() == [2 * m for m in lens]
            and torch.equal(out2d.view(torch.int16), want), "api.decompress_data_stride differs")
    out2d, st, _, _ = launch_once(
        port, "api.decompress_data_stride with a failing row",
        lambda: api.decompress_data_stride(True, rows_s[:fail] + [big] + rows_s[fail + 1:], B, n,
                                           torch.bfloat16, lens), ("decode",))
    others = torch.arange(B, device=dev) != fail
    require(st.tolist() == [1] * fail + [0] + [1] * (B - fail - 1)
            and torch.equal(out2d.view(torch.int16)[others], want[others]),
            "a failing row's status, or another row, differs")
    log(f"  row {fail} failed: status 0, every other row exact")
    del out2d, want, keep
    comp_r, sizes_r, _ = launch_once(
        port, "api.compress_data_stride (raw)",
        lambda: api.compress_data_stride(False, data_f, lengths_f), raw_k)
    same_archives("api.compress_data_stride (raw) archives vs path F's (each its single-tensor "
                  "archive)", comp_r, sizes_r, bat["F"]["arcs"].view(torch.uint8),
                  bat["F"]["sizes"].tolist())
    rows_r = rows(comp_r, sizes_r)
    out_r, st, sz, _ = launch_once(
        port, "api.decompress_data_stride (raw)",
        lambda: api.decompress_data_stride(False, rows_r, len(lengths_f), RAW_CAP, torch.uint8,
                                           lengths_f), ("decode_raw",))
    require(st.tolist() == [1] * len(lengths_f) and sz.tolist() == lengths_f
            and torch.equal(out_r, data_f), "api.decompress_data_stride (raw) differs")
    log("  raw stride rows round-trip exactly (zeros past each length)")
    del out_r

    # ---- info and sizes ----
    for ca, comp_i, arcs_i, want_size in ((True, comp, arcs, [n] * B),
                                          (False, comp_r, rows_r, lengths_f)):
        dev_info = launch_once(port, f"api.get_compressed_info_device({ca})",
                               lambda: api.get_compressed_info_device(ca, comp_i), ())
        host = api.get_compressed_info(ca, arcs_i)
        second = "float_type" if ca else "prob_bits"
        # the device's key -> the host's (a raw archive's size is its byte count)
        keys = {"size": "size" if ca else "total_uncompressed_words", second: second,
                "checksum": "checksum"}
        head = {k: [h[hk] for h in host] for k, hk in keys.items()}
        require(all(v.device == comp_i.device for v in dev_info.values()),
                "header info left the archives' device")
        require({k: dev_info[k].tolist() for k in head} == head and head["size"] == want_size
                and head[second] == [BF16 if ca else 10] * len(arcs_i)
                and bool(dev_info["valid"].all()), f"archive info ({ca}) differs")
    ts = list(x2d)
    bound = api.max_float_compressed_size(torch.bfloat16, n)
    require(api.max_float_compressed_output_size(ts) == (B, bound)
            and torch_api.max_float_compressed_output_size(ts) == (bound, B)
            and max(sizes.tolist()) <= bound
            and api.max_any_compressed_output_size(rows_r) == (len(rows_r), max(
                api.max_any_compressed_size(a.numel()) for a in rows_r))
            and max(sizes_r.tolist()) <= api.max_any_compressed_size(max(lengths_f)),
            "the max_* size queries differ")
    log("  header info on the card equals the host's and the headers; max_* bounds hold")

    # ---- timing, beside path G's calls on the same words ----
    ts_g, outs_g, comp_g, sizes_g, _ = gh["G"]
    rows_g = rows(comp_g, sizes_g)
    t_c, t_nc = (torch.empty_like(flat), strided_t_out())
    calls = {
        "G torch_api.compress_data": lambda: torch_api.compress_data(True, ts_g),
        "Gs torch_api.compress_data_split_size":
            lambda: torch_api.compress_data_split_size(True, flat, splits),
        "Gs api.compress_data_stride (all rows 512Ki)":
            lambda: api.compress_data_stride(True, x2d),
        "G torch_api.decompress_data (in place)":
            lambda: torch_api.decompress_data(True, rows_g, outs_g),
        "Gs torch_api.decompress_data_split_size (contiguous t_out)":
            lambda: torch_api.decompress_data_split_size(True, arcs, t_c, splits),
        "Gs torch_api.decompress_data_split_size (t_out not contiguous)":
            lambda: torch_api.decompress_data_split_size(True, arcs, t_nc, splits),
        "Gs api.decompress_data_stride (all rows 512Ki)":
            lambda: api.decompress_data_stride(True, arcs, B, n, torch.bfloat16),
    }
    raw = 2 * B * n
    timing = []
    log(f"  path G and Gs calls, {ITERS} iterations, CUDA events; card: {card}")
    for what, fn in calls.items():
        ms = time_ms(fn, ITERS)
        timing.append({"call": what, "ms": ms, "gbps": raw / ms / 1e6})
        log(f"  {what:62s} {ms:9.4f} ms  {raw / ms / 1e6:9.3f} GB/s")
    for what, fn, nbytes in (
            ("Gs api.compress_data_stride (raw, path F's rows)",
             lambda: api.compress_data_stride(False, data_f, lengths_f), sum(lengths_f)),
            ("Gs api.decompress_data_stride (raw, path F's rows)",
             lambda: api.decompress_data_stride(False, rows_r, len(lengths_f), RAW_CAP,
                                                torch.uint8, lengths_f), sum(lengths_f))):
        ms = time_ms(fn, ITERS)
        timing.append({"call": what, "ms": ms, "gbps": nbytes / ms / 1e6})
        log(f"  {what:62s} {ms:9.4f} ms  {nbytes / ms / 1e6:9.3f} GB/s")
    torch.cuda.empty_cache()
    return timing


def batch_inputs(dev):
    """Paths D and E's words (standard normal f32 from default_rng(0), and
    the same truncated to bf16), and path F's bytes and lengths."""
    import numpy as np
    import torch

    x = np.random.default_rng(0).standard_normal((BATCH, MEMBER_WORDS)).astype(np.float32)
    words_e = torch.from_numpy(x.view(np.int32)).to(dev)
    words_d = (words_e >> 16).to(torch.int16).view(torch.int32)  # (B, Lw/2) word pairs
    del x
    rng = np.random.default_rng(0)
    lengths = rng.integers(RAW_CAP // 4, RAW_CAP + 1, RAW_MEMBERS).tolist()
    data = torch.empty((RAW_MEMBERS, RAW_CAP), dtype=torch.uint8, device=dev)
    for m, n in enumerate(lengths):  # as benchmarks/sweep.py:118, one member at a time
        row = np.minimum(rng.exponential(30, RAW_CAP), 255).astype(np.uint8)
        row[n:] = 0
        data[m] = torch.from_numpy(row)
    return words_d, words_e, data, lengths


COLL_SMALL = (4096, 5000)  # path K's cross-check against the gloo CPU route, words
COLL_ITERS = 10  # timed calls per collective (the median is kept)
_HALF = {"split": 1, "tables": 1, "encode": 1, "sections": 1, "assembly": 1, "decode": 1}
_RAW = {"hist": 1, "tables": 1, "encode": 1, "sections": 1, "assembly": 1, "decode_raw": 1}
# path K's calls: name -> (function of dietgpu_tpu_torch.parallel, input,
# keyword arguments, the launches of one call, the raw collective timed
# beside it). Inputs: A's bf16 words, a (1, n) row of them for the
# all-to-all, B's f32 words, C's bytes. A float budget is a share of the
# raw bytes: B's words compress to 0.837 of raw, past the default 0.75.
COLL_CALLS = {
    "all_gather": ("compressed_all_gather", "bf16", {}, _HALF, "all_gather"),
    "all_gather_raw": ("compressed_all_gather", "bf16", {"budget_bytes": 1024},
                       {"split": 1, "tables": 1, "encode": 1, "sections": 1, "assembly": 1},
                       "all_gather"),
    "all_gather_auto": ("compressed_all_gather_auto", "bf16", {}, _HALF, "all_gather"),
    "all_to_all": ("compressed_all_to_all", "bf16_row", {}, _HALF, "all_to_all"),
    "reduce_scatter": ("compressed_reduce_scatter", "bf16", {}, _HALF, "reduce_scatter"),
    "all_reduce": ("compressed_all_reduce", "bf16", {}, {k: 2 for k in _HALF}, "all_reduce"),
    "ppermute": ("compressed_ppermute", "bf16", {}, _HALF, "copy_"),
    "all_gather_f32": ("compressed_all_gather", "f32", {"budget_bytes": 0.875},
                       {"split_f32": 1, "tables": 1, "encode": 1, "sections": 1,
                        "assembly": 1, "decode_f32": 1},
                       "all_gather"),
    "shard": ("shard", "bytes", {"shared_stats": False}, _RAW, None),
    # the shared weights from the summed counts, then the table from them
    "shard_shared_stats": ("shard", "bytes", {"shared_stats": True}, {**_RAW, "tables": 2},
                           None),
}


def coll_call(parallel, name, x, group, sent=None):
    """One call of path K: (output, flag). The shard codec's call is
    shard_compress then shard_decompress; its flag is the decode's ok, and
    its (archive, size) goes to `sent` as a batch of one."""
    fn, _, kw, _, _ = COLL_CALLS[name]
    if isinstance(kw.get("budget_bytes"), float):
        kw = {**kw, "budget_bytes": -(-int(x.nbytes * kw["budget_bytes"]) // 16) * 16}
    if fn == "shard":
        arc, size = parallel.shard_compress(x, x.numel(), group, **kw)
        if sent is not None:
            sent.append((arc[None], size[None]))
        out, _, ok = parallel.shard_decompress(arc, x.numel(), x.numel(), group)
        return out, bool(ok)
    return getattr(parallel, fn)(x, group=group, **kw)


def coll_input(kind, words_a, words_b, data_c):
    return {"bf16": words_a, "bf16_row": words_a[None], "f32": words_b, "bytes": data_c}[kind]


def median_ms(fn, iters, warmup=2):
    """Median of `iters` calls' CUDA-event times, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def collectives_phase(port, words_a, words_b, data_c):
    """Path K: the compressed collectives and the shard codec at world size
    1 over NCCL on the card (one card; NCCL puts no two ranks of one
    communicator on a device), on A's bf16 words, B's f32 words and C's
    bytes. Each call must give back its input bit for bit, launch exactly
    its kernels, and send the plain pipeline's archive; at COLL_SMALL words
    the same calls on CPU copies through a gloo group of the same rank must
    give the card's outputs, flags and sent archives. Returns the
    `collectives` rows: each call's median ms beside the raw collective's
    on the same tensor and group, with its bytes."""
    import os
    import shutil
    import tempfile
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch import parallel
    from dietgpu_tpu_torch.ans import cuda_encode
    from dietgpu_tpu_torch.floatcodec import codec
    from dietgpu_tpu_torch.parallel import collectives

    # the world is this one process: keep both backends on the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    rdv = tempfile.mkdtemp(prefix="chip_smoke_rdv")
    orig = {k: getattr(collectives, k) for k in ("_compress", "_all_gather", "_all_to_all",
                                                 "_permute")}
    require(parallel.initialize_process_group(
        init_method=f"file://{rdv}/rendezvous", world_size=1, rank=0,
        timeout=timedelta(seconds=120)), "the NCCL process group did not start")
    try:
        require(dist.get_backend() == "nccl", f"default backend {dist.get_backend()}")
        log(f"  torch {torch.__version__}: all-gathers through "
            f"dist.{collectives._ALL_GATHER.__name__}, all-to-alls through "
            "dist.all_to_all_single, votes through dist.all_reduce")
        gloo = dist.new_group(backend="gloo")
        sent, wire = [], [0]

        def compress(x, prob_bits):
            arcs, sizes = orig["_compress"](x, prob_bits)
            sent.append((arcs, sizes))
            return arcs, sizes

        def counted(name, arg):
            def fn(*a):
                wire[0] += a[arg].numel() * a[arg].element_size()
                return orig[name](*a)
            return fn

        # record what each call compresses to send, and the bytes it hands
        # to the exchange
        collectives._compress = compress
        collectives._all_gather = counted("_all_gather", 0)
        collectives._all_to_all = counted("_all_to_all", 0)
        collectives._permute = counted("_permute", 0)

        def sent_archives(name, x, group):
            """(output, flag, [(archive bytes [0, size), size)]) of one call."""
            sent.clear()
            out, flag = coll_call(parallel, name, x, group, sent)
            arcs = [(a[: (s & 0x7FFFFFFF) // 4].cpu(), s) for arcs, sizes in sent
                    for a, s in zip(arcs, sizes.tolist())]
            return out, flag, arcs

        def same_bits(a, b):
            a, b = a.contiguous().reshape(-1), b.contiguous().reshape(-1)
            return a.shape == b.shape and torch.equal(a.view(torch.uint8), b.view(torch.uint8))

        # a tensor on the other backend's device is refused, never moved
        for x, group in ((words_a[:4096].cpu(), None), (words_a[:4096], gloo)):
            try:
                parallel.compressed_all_gather(x, group=group)
            except ValueError:
                continue
            raise AssertionError("a tensor on the wrong device for its group was taken")
        log("  a CPU tensor on the NCCL group and a card tensor on the gloo group raise")

        # the same calls at small sizes: the card over NCCL, the CPU over gloo
        rng = np.random.default_rng(0)
        for n in COLL_SMALL:
            xs = rng.standard_normal(n).astype(np.float32)
            small = (torch.from_numpy((xs.view(np.int32) >> 16).astype(np.int16)).view(torch.bfloat16),
                     torch.from_numpy(xs), torch.from_numpy(np.minimum(
                         rng.exponential(30, C.round_up(n, 4096)), 255).astype(np.uint8)))
            for name, (_, kind, _, _, _) in COLL_CALLS.items():
                x = coll_input(kind, *small)
                card_out, card_flag, card_sent = sent_archives(name, x.cuda(), None)
                cpu_out, cpu_flag, cpu_sent = sent_archives(name, x, gloo)
                require(card_flag == cpu_flag, f"path K {name} n={n}: flags {card_flag}, {cpu_flag}")
                require(same_bits(card_out.cpu(), cpu_out), f"path K {name} n={n}: outputs differ")
                require(same_bits(cpu_out, x), f"path K {name} n={n}: not the identity")
                require(len(card_sent) == len(cpu_sent) and all(
                    s1 == s2 and torch.equal(a1, a2)
                    for (a1, s1), (a2, s2) in zip(card_sent, cpu_sent)),
                    f"path K {name} n={n}: sent archives differ")
        log(f"  at {COLL_SMALL} words every call on the card (NCCL) equals the CPU route "
            "(gloo): outputs, flags, budgets, sent archives; each the identity")

        # full size: A's, B's and C's inputs
        n, L = words_a.numel(), data_c.numel()
        plain = {
            "bf16": codec.float_compress_padded_plain(words_a.view(torch.int16), n,
                                                      C.FLOAT_TYPE_BFLOAT16, 10, False),
            "f32": codec.float_compress_padded_plain(words_b, n, C.FLOAT_TYPE_FLOAT32, 10, False),
            "bytes": cuda_encode.ans_encode_padded_plain(data_c, L, 10, False),
        }
        plain["bf16_row"] = plain["bf16"]
        rows = []
        for name, (fn_name, kind, kw, want, raw_op) in COLL_CALLS.items():
            x = coll_input(kind, words_a, words_b, data_c)
            torch.cuda.synchronize()
            port.reset_kernel_launches()
            wire[0] = 0
            out, flag, arcs = sent_archives(name, x, None)
            torch.cuda.synchronize()
            launches = {k: v for k, v in port.kernel_launches().items() if v}
            require(launches == want, f"path K {name}: launches {launches}, expected {want}")
            require(same_bits(out, x), f"path K {name}: the output is not the input")
            if name == "all_gather_raw":
                require(flag is False, "path K: a 1024-byte budget did not go raw")
            else:
                require(flag is True or (name == "all_gather_auto" and flag > 0),
                        f"path K {name}: flag {flag}")
            parc, psize = plain[kind]
            psize = int(psize)
            for a, s in arcs:
                require(s == psize and torch.equal(a, parc[: psize // 4].cpu()),
                        f"path K {name}: the sent archive differs from the plain pipeline's")
            sent_bytes = wire[0]
            log(f"  {name}: identity, flag {flag}, launches {launches}, {len(arcs)} archive(s) "
                f"compressed to send equal to the plain pipeline's, {sent_bytes} bytes to the "
                "exchange")
            del out, arcs
            sent.clear()
            ms = median_ms(lambda: coll_call(parallel, name, x, None), COLL_ITERS)
            raw_ms = None
            if raw_op == "all_gather":
                raw_ms = median_ms(lambda: orig["_all_gather"](x, None), COLL_ITERS)
            elif raw_op == "all_to_all":
                raw_ms = median_ms(lambda: orig["_all_to_all"](x, None), COLL_ITERS)
            elif raw_op == "reduce_scatter":
                rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
                y = torch.empty_like(x)
                raw_ms = median_ms(lambda: rs(y, x), COLL_ITERS)
            elif raw_op == "all_reduce":
                y = x.clone()
                raw_ms = median_ms(lambda: dist.all_reduce(y), COLL_ITERS)
            elif raw_op == "copy_":
                y = torch.empty_like(x)
                raw_ms = median_ms(lambda: y.copy_(x), COLL_ITERS)
            raw_bytes = x.numel() * x.element_size()
            rows.append({
                "name": name, "call": fn_name, "numel": x.numel(), "dtype": str(x.dtype),
                "ms": ms, "raw_ms": raw_ms, "raw_op": raw_op, "flag": flag,
                "sent_bytes": sent_bytes, "raw_bytes": raw_bytes, "archive_bytes": psize,
                "ratio": psize / raw_bytes, "launches": launches,
            })
            raw = "" if raw_ms is None else f", raw {raw_op} {raw_ms:.4f} ms"
            log(f"  {name}: {ms:.4f} ms{raw}")
            torch.cuda.empty_cache()
    finally:
        for k, v in orig.items():
            setattr(collectives, k, v)
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    return rows


# ---- path L: a compressed GPT-2 XL checkpoint; path A's stages ----
# the gpt2-xl configuration of the public GPT-2 release (Radford et al.
# 2019, Table 2, 1542M parameters); 25 heads, which set no parameter shape
GPT2_XL = {"layers": 48, "width": 1600, "vocab": 50257, "ctx": 1024}
CKPT_CALLS = 3  # timed calls of save, load, torch.save and torch.load (median kept)
CKPT_CPU_ENTRIES = 40  # the smallest entries, saved again through device="cpu"
CKPT_DISK_LAYERS = 4  # the layers written to a file in a temporary directory
CKPT_PLAIN_BYTES = 1 << 28  # padded input of one plain-pipeline call of path L's check
# path A's stage ranges, and the stage each of its kernels must launch in
A_STAGES = ("float.split", "float.stats", "float.ans_encode", "ans.encode_kernel",
            "ans.sections", "ans.assembly", "float.fused_decode_join")
STAGE_OF_KERNEL = {"split_kernel": "float.split", "tables_kernel": "float.stats",
                   "encode_kernel": "ans.encode_kernel", "sections_kernel": "ans.sections",
                   "assembly_kernel": "ans.assembly", "decode_kernel": "float.fused_decode_join"}


def gpt2_state_dict(dev, layers, width, vocab, ctx, seed=0):
    """GPT-2's parameters under the Hugging Face names, drawn on `dev` from
    a seeded generator as GPT-2 initialises them: matrices and embeddings
    normal with std 0.02, the residual projections 0.02 / sqrt(2 layers),
    LayerNorm weights one, LayerNorm and linear biases zero. Matrices and
    embeddings in bf16, LayerNorm parameters and biases in f32, as mixed
    precision keeps them; an int64 step and the bool causal mask."""
    import math

    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(rows, cols, std=0.02):
        return (torch.randn((rows, cols), generator=gen, device=dev) * std).to(torch.bfloat16)

    def f32(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    proj = 0.02 / math.sqrt(2 * layers)
    sd = {"transformer.wte.weight": normal(vocab, width),
          "transformer.wpe.weight": normal(ctx, width)}
    for i in range(layers):
        p = f"transformer.h.{i}."
        sd.update({
            p + "ln_1.weight": f32(width, 1.0), p + "ln_1.bias": f32(width, 0.0),
            p + "attn.c_attn.weight": normal(width, 3 * width),
            p + "attn.c_attn.bias": f32(3 * width, 0.0),
            p + "attn.c_proj.weight": normal(width, width, proj),
            p + "attn.c_proj.bias": f32(width, 0.0),
            p + "ln_2.weight": f32(width, 1.0), p + "ln_2.bias": f32(width, 0.0),
            p + "mlp.c_fc.weight": normal(width, 4 * width),
            p + "mlp.c_fc.bias": f32(4 * width, 0.0),
            p + "mlp.c_proj.weight": normal(4 * width, width, proj),
            p + "mlp.c_proj.bias": f32(width, 0.0),
        })
    sd["transformer.ln_f.weight"] = f32(width, 1.0)
    sd["transformer.ln_f.bias"] = f32(width, 0.0)
    sd["step"] = torch.tensor(1000, dtype=torch.int64, device=dev)
    sd["attn_mask"] = torch.ones((ctx, ctx), dtype=torch.bool, device=dev).tril()
    return sd


def checkpoint_entries(blob):
    """(name, kind, dtype code, shape, archive bytes) of each entry of a
    checkpoint file's bytes, in order (the container layout of
    ``dietgpu_tpu_torch.checkpoint``)."""
    import struct

    view = memoryview(blob)
    magic, _, n, _ = struct.unpack_from("<IIII", view, 0)
    require(magic == 0xD1E77D17, f"not a checkpoint (magic 0x{magic:08x})")
    off, out = 16, []
    for _ in range(n):
        (nl,) = struct.unpack_from("<I", view, off)
        name = bytes(view[off + 4 : off + 4 + nl]).decode()
        off += 4 + nl
        kind, code, ndim = struct.unpack_from("<BBH", view, off)
        shape = struct.unpack_from(f"<{ndim}Q", view, off + 4)
        (al,) = struct.unpack_from("<Q", view, off + 4 + 8 * ndim)
        off += 12 + 8 * ndim
        out.append((name, kind, code, shape, view[off : off + al]))
        off += al
    require(off == len(blob), "bytes past the checkpoint's last entry")
    return out


def same_tensor(a, b):
    """Equal dtype, shape and bits."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        word = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(word), b.view(word)
    return torch.equal(a, b)


def single_archive(port, t):
    """Tensor t's archive through the single-tensor kernel path with the
    checkpoint's settings (prob_bits 10, checksum), as host bytes: the
    float codec for f16/bf16/f32, else raw ANS of its bytes."""
    import numpy as np
    import torch

    if t.dtype in (torch.float16, torch.bfloat16, torch.float32):
        return port.float_compress(t, 10, True).view(torch.uint8).cpu().numpy()
    data = t.reshape(-1).view(torch.uint8)
    n = data.numel()
    padded = torch.zeros(-(-max(n, 1) // 4096) * 4096, dtype=torch.uint8, device=t.device)
    padded[:n] = data
    arc, size = port.ans_encode_padded(padded, n, 10, True)
    return np.asarray(arc.view(torch.uint8)[: int(size)].cpu().numpy())


def checkpoint_vs_plain(sd, entries, groups):
    """Each entry's archive in path L's file against the plain pipeline on
    the card, at the kernels' own shapes: the checkpoint's groups (kind,
    float type, power-of-two class of the word or byte count), each padded
    to its widest member as ``api.compress_data`` pads it, through
    ``float_compress_batched_plain`` / ``ans_encode_batched_plain`` with
    the checksum, in runs of rows of at most CKPT_PLAIN_BYTES (a member's
    archive does not depend on the rows beside it). Returns the number of
    plain calls."""
    import numpy as np
    import torch

    from dietgpu_tpu_torch.ans import cuda_encode
    from dietgpu_tpu_torch.floatcodec import codec

    floats = {torch.float16: 1, torch.bfloat16: 2, torch.float32: 3}
    word = {2: torch.int16, 4: torch.int32}
    archives = {name: arc for name, *_, arc in entries}
    grouped = {}
    for name, t in sd.items():
        flat = t.reshape(-1)
        flat = flat.view(word[t.element_size()] if t.dtype in floats else torch.uint8)
        key = (floats.get(t.dtype, 0), max(flat.numel() - 1, 0).bit_length())
        grouped.setdefault(key, []).append((name, flat))
    require(len(grouped) == groups,
            f"path L: {len(grouped)} groups by kind, type and size class; the save encoded {groups}")
    calls = 0
    for (ft, _), members in grouped.items():
        width = -(-max(max(f.numel() for _, f in members), 1) // 4096) * 4096
        step = max(1, CKPT_PLAIN_BYTES // (width * members[0][1].element_size()))
        for i in range(0, len(members), step):
            run = members[i : i + step]
            rows = torch.zeros((len(run), width), dtype=run[0][1].dtype, device=run[0][1].device)
            for m, (_, f) in enumerate(run):
                rows[m, : f.numel()] = f
            lens = [f.numel() for _, f in run]
            if ft:
                pa, ps = codec.float_compress_batched_plain(rows, lens, ft, 10, True)
            else:
                pa, ps = cuda_encode.ans_encode_batched_plain(rows, lens, None, 10, True)
            pa = pa.view(torch.uint8)
            for m, ((name, _), size) in enumerate(zip(run, ps.tolist())):
                require(size >= 0, f"path L: {name} overflowed in the plain pipeline")
                require(np.array_equal(pa[m, :size].cpu().numpy(),
                                       np.frombuffer(archives[name], np.uint8)),
                        f"path L: {name}'s archive differs from the plain pipeline's")
            calls += 1
            del rows, pa, ps
    return calls


def median_s(fn, calls=CKPT_CALLS):
    """Median host seconds of `calls` synchronised calls (a first call
    warms up)."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def checkpoint_path(port, dev, card, words_a, arc_a, size_a):
    """Path L: a GPT-2 XL state dict through ``checkpoint.save_arrays`` /
    ``load_arrays`` on the card (an io.BytesIO, prob_bits 10, checksum
    on). Checks that the tensors come back bit for bit, that each entry's
    archive in the file equals its single-tensor kernel archive and the
    plain pipeline's on the card at its group's shape, that the
    smallest entries give the same archives through device="cpu", that a
    file on disk equals the BytesIO bytes, and that the CLI, in
    subprocesses on the card, gives path A's archive and words back.
    Returns the `checkpoint` line's numbers."""
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from dietgpu_tpu_torch import checkpoint

    sd = gpt2_state_dict(dev, **GPT2_XL)
    raw = sum(t.numel() * t.element_size() for t in sd.values())
    log(f"# phase 5: path L, a GPT-2 XL checkpoint: {len(sd)} entries, {raw} bytes, "
        f"prob_bits 10, checksum on")

    def save_load():
        buf = io.BytesIO()
        checkpoint.save_arrays(buf, sd)
        buf.seek(0)
        return buf.getvalue(), checkpoint.load_arrays(buf)

    (blob, back), launches = drive(port, "L", save_load)
    groups = launches["encode"]
    require(launches["decode"] + launches["decode_f32"] + launches["decode_raw"] == groups,
            "path L: the load did not decode each group once")
    require(list(back) == list(sd), "path L: the entries came back in another order")
    require(all(t.is_cuda for t in back.values()), "path L: a tensor was loaded off the card")
    require(all(same_tensor(back[k], v) for k, v in sd.items()),
            "path L: a loaded tensor differs from the original")
    del back
    log(f"  {len(sd)} tensors back bit for bit; {groups} groups; file {len(blob)} bytes, "
        f"ratio {len(blob) / raw:.6f}")

    entries = checkpoint_entries(blob)
    require([e[0] for e in entries] == list(sd), "path L: the file's entries differ")
    for name, _, _, shape, arc in entries:
        require(tuple(sd[name].shape) == shape, f"path L: {name}'s shape differs")
        require(np.array_equal(np.frombuffer(arc, np.uint8), single_archive(port, sd[name])),
                f"path L: {name}'s archive differs from its single-tensor archive")
    log("  each entry's archive equals its single-tensor kernel archive")
    calls = checkpoint_vs_plain(sd, entries, groups)
    log(f"  each entry's archive equals the plain pipeline's on the card, its group padded "
        f"as the save pads it ({groups} groups, {calls} batched plain calls)")

    small = sorted(sd, key=lambda k: sd[k].numel() * sd[k].element_size())[:CKPT_CPU_ENTRIES]
    buf = io.BytesIO()
    checkpoint.save_arrays(buf, {k: sd[k].cpu() for k in small}, device="cpu")
    on_card = {e[0]: bytes(e[4]) for e in entries}
    require(all(bytes(arc) == on_card[name] for name, *_, arc in checkpoint_entries(
        buf.getvalue())), "path L: the CPU route's archives differ from the card's")
    log(f"  the {CKPT_CPU_ENTRIES} smallest entries give the same archives through "
        f"device='cpu'")

    layers = {k: v for k, v in sd.items()
              if k.startswith(tuple(f"transformer.h.{i}." for i in range(CKPT_DISK_LAYERS)))}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpt2-xl.dgt")
        checkpoint.save_arrays(path, layers)
        buf = io.BytesIO()
        checkpoint.save_arrays(buf, layers)
        with open(path, "rb") as f:
            require(f.read() == buf.getvalue(), "path L: the file differs from the BytesIO bytes")
        back = checkpoint.load_arrays(path)
        require(all(same_tensor(back[k], v) for k, v in layers.items()),
                "path L: the file read back differs")
    del back, buf
    log(f"  a file of the first {CKPT_DISK_LAYERS} layers ({len(layers)} entries) equals the "
        "BytesIO bytes and reads back")

    # NaN payloads a float copy on the card would rewrite as 0x7FFF
    nans = {}
    for dtype, word, bits in ((torch.float16, torch.int16, (0x7E01, -0x0200, 0x7C01)),
                              (torch.bfloat16, torch.int16, (0x7FC1, -0x0040, 0x7F81)),
                              (torch.float32, torch.int32, (0x7FC00001, -0x00400000))):
        w = sd["transformer.ln_f.weight"].to(dtype).view(word).clone()
        w[: len(bits)] = torch.tensor(bits, dtype=word, device=dev)
        nans[str(dtype)] = w.view(dtype)
    buf = io.BytesIO()
    checkpoint.save_arrays(buf, nans)
    buf.seek(0)
    back = checkpoint.load_arrays(buf)
    require(all(same_tensor(back[k], v) for k, v in nans.items()),
            "path L: a NaN payload did not come back bit for bit")
    log("  f16, bf16 and f32 NaN payloads come back bit for bit")

    save_s = median_s(lambda: checkpoint.save_arrays(io.BytesIO(), sd))
    load_s = median_s(lambda: checkpoint.load_arrays(io.BytesIO(blob)))
    tbuf = io.BytesIO()
    torch.save(sd, tbuf)
    tblob = tbuf.getvalue()
    del tbuf
    tsave_s = median_s(lambda: torch.save(sd, io.BytesIO()))
    tload_s = median_s(lambda: torch.load(io.BytesIO(tblob), weights_only=True))
    torch.cuda.empty_cache()
    for what, s in (("save_arrays", save_s), ("load_arrays", load_s),
                    ("torch.save", tsave_s), ("torch.load", tload_s)):
        log(f"  {what:12s} {s * 1e3:10.2f} ms  {raw / s / 1e9:8.3f} GB/s of raw bytes "
            f"(median of {CKPT_CALLS}; {card})")

    cli_s = cli_phase(words_a, arc_a, size_a)
    return {
        "model": "gpt2-xl (Radford et al. 2019, Table 2): 48 layers, width 1600, "
                 "vocabulary 50257, context 1024; weights drawn from seed 0",
        "entries": len(sd), "groups": groups, "raw_bytes": raw, "file_bytes": len(blob),
        "ratio": len(blob) / raw, "torch_file_bytes": len(tblob),
        "save_ms": save_s * 1e3, "load_ms": load_s * 1e3,
        "save_gbps": raw / save_s / 1e9, "load_gbps": raw / load_s / 1e9,
        "torch_save_ms": tsave_s * 1e3, "torch_load_ms": tload_s * 1e3,
        "torch_save_gbps": raw / tsave_s / 1e9, "torch_load_gbps": raw / tload_s / 1e9,
        "calls": CKPT_CALLS, "launches_save_and_load": {k: v for k, v in launches.items() if v},
        "cli_s": cli_s, "card": card,
    }


def cli_phase(words_a, arc_a, size_a):
    """The file CLI in subprocesses on the card: path A's bf16 words
    through `compress --float bf16 --no-checksum`, `info` and `decompress`;
    the archive must equal path A's and the words come back. Returns the
    seconds of each subprocess."""
    import os
    import tempfile

    import numpy as np
    import torch

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    n = words_a.numel() * 2

    def cli(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "dietgpu_tpu_torch.cli", *args],
                           capture_output=True, text=True, cwd=root, env=env, timeout=300)
        require(r.returncode == 0, f"cli {args[0]} exited {r.returncode}: {r.stderr[-3000:]}")
        return r, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        src, arc, out = (os.path.join(tmp, f) for f in ("words.bin", "words.dg", "back.bin"))
        words = words_a.cpu().numpy()
        words.tofile(src)
        _, t_c = cli("compress", "--float", "bf16", "--no-checksum", src, arc)
        r, t_i = cli("info", arc)
        _, t_d = cli("decompress", arc, out)
        info = json.loads(r.stdout)
        require(info == {"size": n, "float_type": 2, "use_checksum": False, "checksum": 0,
                         "kind": "float", "float_type_name": "bf16"},
                f"cli info: {info}")
        want = arc_a.view(torch.uint8)[:size_a].cpu().numpy()
        require(np.array_equal(np.fromfile(arc, np.uint8), want),
                "cli: the archive differs from path A's")
        require(np.array_equal(np.fromfile(out, np.uint8), words.view(np.uint8)),
                "cli: the words did not come back")
    log(f"  cli in subprocesses on the card: compress {t_c:.1f} s, info {t_i:.1f} s, "
        f"decompress {t_d:.1f} s; archive equals path A's, words back bit for bit")
    return {"compress": t_c, "info": t_i, "decompress": t_d}


def stages_phase(port, words, n, Lw, ft):
    """Profile one path A compress and decompress with profiler_start /
    profiler_stop; every stage of the path must be in the trace, once, and
    each kernel's launch inside its stage. Returns the `stages` rows."""
    import re
    import tempfile

    import torch

    from dietgpu_tpu_torch import profiling

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        profiling.profiler_start(tmp)
        try:
            arc, _ = port.float_compress_padded(words, n, ft, 10, False)
            port.float_decompress_padded(arc, ft, Lw, 10, False, static_length=n)
        finally:
            profiling.profiler_stop()
        rows, launches = profiling.stage_account(profiling.read_trace(tmp))
    for stage in A_STAGES:
        require(rows.get(stage, {}).get("calls") == 1, f"stage {stage} is not once in the trace")
    for kernel, stage in STAGE_OF_KERNEL.items():
        seen = [st for name, st, _ in launches if re.search(rf"\b{kernel}\b", name)]
        require(seen == [stage], f"kernel {kernel} launched in stages {seen}, not once in "
                f"{stage}; device events: {[(k, st) for k, st, _ in launches][:40]}")
    for stage, r in rows.items():
        log(f"  {stage:28s} host {r['host_ms']:8.4f} ms (self {r['host_self_ms']:8.4f}), "
            f"device {r['device_ms']:8.4f} ms (self {r['device_self_ms']:8.4f})")
    return rows


# each captured call's kernels, one launch of each at the capture
CAPTURE_KERNELS = {
    "float": ("split", *ENC),
    "float32": ("split_f32", *ENC),
    "raw": ("hist", *ENC),
    "decode": ("decode",),
    "decode_f32": ("decode_f32",),
    "decode_raw": ("decode_raw",),
    "join": ("join",),
    "join_f32": ("join_f32",),
}


def capture_call(port, what, fn, inputs, view, kernels):
    """One call of a path under a CUDA graph: an eager warm-up on a copy of
    inputs[0] under torch.cuda.set_sync_debug_mode("error"), a capture with
    the launch counters at 0 before it (each kernel of `kernels` recorded
    once, no other), then for each input set a copy into the static
    buffers, a replay, and an eager call on the same input: view() of both
    must be equal bit for bit, and the replays count no launch. Then the
    eager call and the replay are timed. Returns (the eager outputs, in
    input order; eager ms; replay ms; the launches recorded)."""
    import torch

    static = tuple(x.clone() for x in inputs[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*static)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    port.reset_kernel_launches()
    with torch.cuda.graph(g):
        out = fn(*static)
    torch.cuda.synchronize()
    launches = {k: v for k, v in port.kernel_launches().items() if v}
    require(launches == dict.fromkeys(kernels, 1),
            f"{what}: the capture recorded {launches}, want each of {kernels} once")
    eager = []
    for k, xs in enumerate(inputs):
        for s, x in zip(static, xs):
            s.copy_(x)
        port.reset_kernel_launches()
        g.replay()
        require(not any(port.kernel_launches().values()), f"{what}: a replay counted a launch")
        eager.append(fn(*xs))
        torch.cuda.synchronize()
        got, want = view(out), view(eager[-1])
        require(len(got) == len(want) and all(
            a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want)),
            f"{what}: replay on input {k} differs from the eager call")
    eager_ms = time_ms(lambda: fn(*static), ITERS)
    replay_ms = time_ms(g.replay, ITERS)
    del g, out
    return eager, eager_ms, replay_ms, launches


def archive_view(res):
    """The sizes and each row's archive [0, size) of (archives, sizes)."""
    arcs, sizes = res
    if arcs.dim() == 1:
        arcs, sizes = arcs[None], sizes[None]
    return [sizes, *(arcs[m, : (s & 0x7FFFFFFF) // 4] for m, s in enumerate(sizes.tolist()))]


def result_view(res):
    """Every output of a decompress: words or bytes, sizes, statuses."""
    return [res[k] for k in sorted(res)]


def variants(x, lengths=None):
    """Three inputs of x's shape: x and two rotations of its words (each
    row's, zero past its length, when `lengths` is given), so that no
    replay sees an archive that an earlier one made."""
    import torch

    if lengths is None:
        return [x] + [torch.roll(x.view(-1), s).view_as(x) for s in (12347, 777777)]
    keep = torch.arange(x.shape[1], device=x.device)[None, :] < torch.tensor(
        lengths, device=x.device)[:, None]
    return [x] + [torch.where(keep, torch.roll(x, s, 1), 0) for s in (12347, 777777)]


def captured_phase(port, card, paths):
    """Each path's compress and decompress (for J, its two joins) captured
    once in a CUDA graph and replayed on three inputs, each replay equal to
    an eager call on the same input, each eager output what it must be.
    `paths` maps a path to a function that makes its calls, in order: (call
    name, raw bytes, fn, inputs, view, kernels, expect). `inputs` is a list
    of input tuples, or a function of the eager outputs of the call before
    it (a decompress takes the compress's archives); expect(k, output), if
    given, holds the eager output of input k against its input. Returns
    the rows of the ``captured`` line."""
    import torch

    from dietgpu_tpu_torch import _build

    rows, recorded = [], set()
    for name, make_calls in paths.items():
        log(f"  path {name}: each call captured once, replayed on 3 inputs against eager calls")
        eager = None
        for call, raw, fn, inputs, view, kernels, expect in make_calls():
            if callable(inputs):
                inputs = inputs(eager)
            eager, eager_ms, replay_ms, launches = capture_call(
                port, f"path {name} {call}", fn, inputs, view, CAPTURE_KERNELS[kernels])
            del inputs
            recorded.update(launches)
            if expect is not None:
                for k, res in enumerate(eager):
                    require(expect(k, res), f"path {name} {call}: input {k} did not come back")
            rows.append({"path": name, "call": call, "eager_ms": eager_ms,
                         "replay_ms": replay_ms, "eager_gbps": raw / eager_ms / 1e6,
                         "replay_gbps": raw / replay_ms / 1e6, "launches": launches})
            log(f"    {call:10s} eager {eager_ms:8.4f} ms ({raw / eager_ms / 1e6:9.3f} GB/s)  "
                f"replay {replay_ms:8.4f} ms ({raw / replay_ms / 1e6:9.3f} GB/s)  "
                f"recorded {launches}")
        del eager
        torch.cuda.empty_cache()
    require(recorded == set(_build.KERNELS),
            f"kernels never captured: {sorted(set(_build.KERNELS) - recorded)}")
    log(f"  every kernel ran inside a graph; card: {card}")
    return rows


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dietgpu_tpu_torch as port
    from dietgpu_tpu_torch import _build
    from dietgpu_tpu_torch import constants as C
    from dietgpu_tpu_torch.ans import cuda_decode, cuda_encode, cuda_hist, layout, stats
    from dietgpu_tpu_torch.ans import encode as plain_encode
    from dietgpu_tpu_torch.floatcodec import codec, cuda_float

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"# build: {time.perf_counter() - t0:.1f} s for {sorted(built) or 'cached'}")
    for k in _build._RESOURCES:
        log(f"# resources of {k}: {_build.kernel_resources(k)}")

    # ---- 2. each kernel against its plain version, small shapes ----
    log("# phase 2: kernels vs plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    Lw = 1 << 20
    for ft in (C.FLOAT_TYPE_FLOAT16, C.FLOAT_TYPE_BFLOAT16):
        pairs = torch.randint(
            -(1 << 31), 1 << 31, (Lw // 2,), dtype=torch.int32, device=dev, generator=gen
        )
        for n in (Lw, Lw - 12345):
            require_exact(
                f"split ft={ft} n={n}",
                zip(one(cuda_float.split_words_batched_cuda(pairs[None], n, ft, True)),
                    cuda_float.split_words_plain(pairs, n, ft, True)),
            )

    x = torch.randn(Lw, generator=gen, device=dev)
    words = (x.view(torch.int32) >> 16).to(torch.int16)
    for ft, n in ((C.FLOAT_TYPE_BFLOAT16, Lw - 777), (C.FLOAT_TYPE_FLOAT16, Lw)):
        w = words if ft == C.FLOAT_TYPE_BFLOAT16 else x.half().view(torch.int16)
        for ck in (False, True):
            ka, ks = codec.float_compress_padded(w, n, ft, 10, ck)
            pa, ps = codec.float_compress_padded_plain(w, n, ft, 10, ck)
            size = int(ks)
            require_exact(f"encode+assembly archive ft={ft} n={n} ck={ck}",
                          [(ks, ps), (ka[: size // 4], pa[: size // 4])])
            for digest in (False, True):
                require_exact(
                    f"decode ft={ft} n={n} digest={digest}",
                    zip(cuda_decode.decode_float(ka, ft, Lw, 10, None, digest),
                        cuda_decode.decode_float_plain(ka, ft, Lw, 10, None, digest)),
                )
            r = codec.float_decompress_padded(ka, ft, Lw, 10, ck, static_length=n)
            if not (bool(r["success"]) and bool(r["checksum_ok"])):
                raise AssertionError("small roundtrip failed its status")
            if not torch.equal(r["out32"].view(torch.int16)[:n], w[:n]):
                raise AssertionError("small roundtrip differs")
    # a lying header and a corrupted payload
    bad = ka.clone()
    bad[1] += 4096
    for fn in (cuda_decode.decode_float, cuda_decode.decode_float_plain):
        if bool(fn(bad, ft, Lw, 10)[1]):
            raise AssertionError("a lying header decoded with success")
    bad = ka.clone()
    bad[4 + 100] ^= 0x01000000
    if bool(codec.float_decompress_padded(bad, ft, Lw, 10, True)["checksum_ok"]):
        raise AssertionError("a corrupted nonComp byte passed the checksum")
    log("  lying header fails success; corrupted payload fails checksum_ok")

    # an overflowing block: weight-1 symbols at prob_bits 11
    rare = torch.arange(1, 256, device=dev, dtype=torch.uint8).repeat(17)[:4096]
    data = torch.cat([torch.zeros(16 * 4096, dtype=torch.uint8, device=dev), rare])
    pdf = stats.normalize_probs(torch.bincount(data.long().cpu(), minlength=256).to(dev),
                                data.numel(), 11)
    table = plain_encode.encode_table(pdf)
    d32 = layout.u8_to_u32le(data)
    ke = cuda_encode.encode_blocks_batched_cuda(d32[None], data.numel(), 11, table[None])
    pe = plain_encode.encode_blocks_batched(d32[None], data.numel(), 11, table[None])
    if int(ke[1].max()) <= C.MAX_COMP_WORDS_PER_BLOCK:
        raise AssertionError("the overflow input did not overflow")
    require_exact("encode overflow block",
                  [(ke[1], pe[1]), (ke[2], pe[2])] + staged_pairs(ke[0], pe[0], ke[1].clamp(max=2560)))

    phase2_new_kernels(port, dev)
    phase2_batched_kernels(port, dev)
    phase2_slice4(port, dev)
    phase2_slice5(port, dev)
    phase2_slice6(port, dev)
    phase2_slice7(port, dev)
    err_uniform = phase2_slice10(port, dev)
    del x, words, w, ka, pa, bad, rare, data
    torch.cuda.empty_cache()

    # ---- 3. path A ----
    log(f"# phase 3: path A, bf16 {MWORDS}Mi words, prob_bits 10, no checksum")
    n = MWORDS * 1024 * 1024
    Lw = C.round_up(n, C.DEFAULT_BLOCK_SIZE)
    ft = C.FLOAT_TYPE_BFLOAT16
    raw_bytes = n * 2
    rng = np.random.default_rng(0)
    inputs = []
    for _ in range(3):  # as bench.py:118-124
        xs = rng.standard_normal(Lw).astype(np.float32)
        w = (xs.view(np.uint32) >> 16).astype(np.uint16)
        w[n:] = 0
        inputs.append(torch.from_numpy(w.view(np.int32)).to(dev))
    del xs, w

    def path_a():
        a, s = port.float_compress_padded(inputs[0], n, ft, 10, False)
        return a, s, port.float_decompress_padded(a, ft, Lw, 10, False, static_length=n)

    (arc, size, res), launches_a = drive(port, "A", path_a)
    if not bool(res["success"]) or int(res["size"]) != n:
        raise AssertionError("main-path decode failed its status")
    if not torch.equal(res["out32"][: n // 2], inputs[0][: n // 2]):
        raise AssertionError("main-path roundtrip differs")
    size = int(size)
    parc, psize = codec.float_compress_padded_plain(inputs[0], n, ft, 10, False)
    err_archive = require_exact("main-path archive vs plain pipeline",
                                [(torch.tensor(size), psize.cpu()),
                                 (arc[: size // 4], parc[: size // 4])])
    del parc
    sizes = [size]
    for w in inputs[1:]:
        a2, s2 = port.float_compress_padded(w, n, ft, 10, False)
        r2 = port.float_decompress_padded(a2, ft, Lw, 10, False, static_length=n)
        if not (bool(r2["success"]) and torch.equal(r2["out32"][: n // 2], w[: n // 2])):
            raise AssertionError("main-path roundtrip differs")
        sizes.append(int(s2))
    ratio = sizes[-1] / raw_bytes  # bench.py reports the last input's ratio
    log(f"  roundtrip exact on 3 inputs; ratios {[round(s / raw_bytes, 6) for s in sizes]}")
    if round(ratio, 4) != 0.6742:
        raise AssertionError(f"ratio {ratio:.6f} is not 0.6742")
    log(f"  ratio {ratio:.4f}")

    # every kernel against its plain version at the main path's shapes
    pairs = inputs[0]
    ks = one(cuda_float.split_words_batched_cuda(pairs[None], n, ft))
    err = {"split": require_exact("split, main shape",
                                  zip(ks, cuda_float.split_words_plain(pairs, n, ft)))}
    exp32 = ks[0][None]
    pdf = stats.normalize_probs(ks[2], n, 10)
    table = plain_encode.encode_table(pdf)[None]
    hist_a = ks[2][None].contiguous()
    kt = cuda_encode.quantize_cuda(hist_a, n, 10)
    err["tables"] = require_exact("tables, main shape", [(kt[0], pdf[None]), (kt[1], table)])
    ke = cuda_encode.encode_blocks_batched_cuda(exp32, n, 10, table)
    pe = plain_encode.encode_blocks_batched(exp32, n, 10, table)
    err["encode"] = require_exact("encode, main shape",
                                  [(ke[1], pe[1]), (ke[2], pe[2])] + staged_pairs(ke[0], pe[0], ke[1]))
    del pe
    base32 = 4 + C.round_up(n, 16) // 4
    asm_k = torch.zeros_like(arc)[None]
    sec_k = torch.zeros_like(asm_k)
    prefix, ds32, _, sizes_p = plain_encode.write_sections_batched(
        asm_k, base32, pdf[None], ke[2], ke[1], [n], 10)
    sec = cuda_encode.write_sections_batched_cuda(sec_k, base32, kt[0], ke[2], ke[1], [n], 10)
    err["sections"] = require_exact("sections, main shape", [
        (sec_k, asm_k), (sec[0], prefix), (sec[3], sizes_p), (torch.tensor(sec[1]),
                                                               torch.tensor(ds32))])
    del sec_k, sec
    ds32 = ds32[0]
    asm_p = asm_k.clone()
    cuda_encode.assemble_payload_batched_cuda(asm_k, ds32, ke[0], ke[1], prefix)
    plain_encode.assemble_payload_batched(asm_p, ds32, ke[0], ke[1], prefix)
    err["assembly"] = require_exact("assembly, main shape", [(asm_k, asm_p)])
    del asm_p
    e4 = 0
    for digest in (False, True):
        e4 = max(e4, require_exact(
            f"decode digest={digest}, main shape",
            zip(cuda_decode.decode_float(arc, ft, Lw, 10, n, digest),
                cuda_decode.decode_float_plain(arc, ft, Lw, 10, n, digest)),
        ))
    err["decode"] = e4
    if err_archive:
        raise AssertionError("archive mismatch")
    torch.cuda.empty_cache()

    # ---- 3. path B: f32 ----
    log(f"# phase 3: path B, f32 {MWORDS}Mi words, prob_bits 10, no checksum")
    F32 = C.FLOAT_TYPE_FLOAT32
    raw_b = 4 * n
    rng = np.random.default_rng(0)
    inputs_b = []
    for _ in range(3):  # as benchmarks/sweep.py:79,89
        xs = rng.standard_normal(Lw).astype(np.float32)
        inputs_b.append(torch.from_numpy(xs.view(np.int32)).to(dev))
    del xs

    def path_b():
        a, s = port.float_compress_padded(inputs_b[0], n, F32, 10, False)
        return a, s, port.float_decompress_padded(a, F32, Lw, 10, False, static_length=n)

    (arc_b, size_b, res), launches_b = drive(port, "B", path_b)
    require(bool(res["success"]) and int(res["size"]) == n, "path B decode failed its status")
    require(torch.equal(res["out32"], inputs_b[0]), "path B roundtrip differs")
    size_b = int(size_b)
    parc, psize = codec.float_compress_padded_plain(inputs_b[0], n, F32, 10, False)
    require_exact("path B archive vs plain pipeline",
                                [(torch.tensor(size_b), psize.cpu()),
                                 (arc_b[: size_b // 4], parc[: size_b // 4])])
    del parc
    sizes = [size_b]
    for w in inputs_b[1:]:
        a2, s2 = port.float_compress_padded(w, n, F32, 10, False)
        r2 = port.float_decompress_padded(a2, F32, Lw, 10, False, static_length=n)
        require(bool(r2["success"]) and torch.equal(r2["out32"], w), "path B roundtrip differs")
        sizes.append(int(s2))
    log(f"  roundtrip exact on 3 inputs; ratios {[round(s / raw_b, 6) for s in sizes]}")
    a2, s2 = port.float_compress_padded(inputs_b[1], n, F32, 10, True)
    r2 = port.float_decompress_padded(a2, F32, Lw, 10, True, static_length=n)
    require(bool(r2["success"]) and bool(r2["checksum_ok"])
            and torch.equal(r2["out32"], inputs_b[1]), "path B checksummed call failed")
    log("  checksummed call: roundtrip exact, checksum verified on decode")
    del a2, r2
    kf = one(cuda_float.split_words_f32_batched_cuda(inputs_b[0][None], n))
    err["split_f32"] = require_exact(
        "split_f32, main shape", zip(kf, cuda_float.split_words_f32_plain(inputs_b[0], n)))
    del kf
    e8 = 0
    for digest in (False, True):
        e8 = max(e8, require_exact(
            f"decode_f32 digest={digest}, main shape",
            zip(cuda_decode.decode_float(arc_b, F32, Lw, 10, n, digest),
                cuda_decode.decode_float_plain(arc_b, F32, Lw, 10, n, digest)),
        ))
    err["decode_f32"] = e8
    torch.cuda.empty_cache()

    # ---- 3. path J: the standalone join ----
    log(f"# phase 3: path J, split and join back, bf16 and f32, {MWORDS}Mi words")

    def path_j():
        e, c, _, _ = one(cuda_float.split_words_batched_cuda(inputs[0][None], n, ft))
        wj = port.join_words_packed(e, c, ft)
        e32, lo, hi, _, _ = one(cuda_float.split_words_f32_batched_cuda(inputs_b[0][None], n))
        return (e, c, wj), (e32, lo, hi, port.join_words_packed_f32(e32, lo, hi))

    ((e_j, c_j, wj), (e32_j, lo_j, hi_j, wf)), launches_j = drive(port, "J", path_j)
    require(torch.equal(wj, inputs[0]), "path J: the bf16 join differs from the input")
    require(torch.equal(wf, inputs_b[0]), "path J: the f32 join differs from the input")
    del wj, wf
    err["join"] = require_exact("join, path J shape",
                                [(cuda_float.join_words_cuda(e_j[None], c_j[None], ft),
                                  cuda_float.join_words_plain(e_j[None], c_j[None], ft))])
    err["join_f32"] = require_exact(
        "join_f32, path J shape",
        [(cuda_float.join_words_f32_cuda(e32_j[None], lo_j[None], hi_j[None]),
          cuda_float.join_words_f32_plain(e32_j[None], lo_j[None], hi_j[None]))])
    log("  roundtrips exact against the inputs")
    torch.cuda.empty_cache()

    # ---- 3. path C: raw ANS ----
    L = RAW_BYTES
    log(f"# phase 3: path C, raw ANS {L} bytes, prob_bits 10, no checksum")
    rng = np.random.default_rng(0)
    datas = []
    for _ in range(3):  # as benchmarks/sweep.py:118
        d = np.minimum(rng.exponential(30, L), 255).astype(np.uint8)
        datas.append(torch.from_numpy(d).to(dev))
    del d

    def path_c():
        a, s = port.ans_encode_padded(datas[0], L, 10, False)
        return a, s, port.ans_decode_padded(a, 10, L, False)

    (arc_c, size_c, res), launches_c = drive(port, "C", path_c)
    require(bool(res["success"]) and int(res["size"]) == L, "path C decode failed its status")
    require(torch.equal(res["out"], datas[0]), "path C roundtrip differs")
    size_c = int(size_c)
    parc, psize = cuda_encode.ans_encode_padded_plain(datas[0], L, 10, False)
    require_exact("path C archive vs plain pipeline",
                                [(torch.tensor(size_c), psize.cpu()),
                                 (arc_c[: size_c // 4], parc[: size_c // 4])])
    del parc
    sizes = [size_c]
    for d in datas[1:]:
        a2, s2 = port.ans_encode_padded(d, L, 10, False)
        r2 = port.ans_decode_padded(a2, 10, L, False)
        require(bool(r2["success"]) and torch.equal(r2["out"], d), "path C roundtrip differs")
        sizes.append(int(s2))
    log(f"  roundtrip exact on 3 inputs; ratios {[round(s / L, 6) for s in sizes]}")
    a2, s2 = port.ans_encode_padded(datas[1], L, 10, True)
    r2 = port.ans_decode_padded(a2, 10, L, True)
    require(bool(r2["success"]) and bool(r2["checksum_ok"])
            and torch.equal(r2["out"], datas[1]), "path C checksummed call failed")
    log("  checksummed call: roundtrip exact, checksum verified on decode")
    del a2, r2
    d32c = layout.u8_to_u32le(datas[0])
    err["hist"] = require_exact(
        "hist ck=True, main shape",
        zip(one(cuda_hist.histogram_u8_batched_cuda(d32c[None], [L], True)),
            cuda_hist.histogram_u8_plain(d32c, L, True)),
    )
    e6 = 0
    for digest in (False, True):
        e6 = max(e6, require_exact(
            f"decode_raw digest={digest}, main shape",
            zip(one(cuda_decode.decode_raw_batched_cuda(arc_c[None], 10, L, None, digest)),
                cuda_decode.decode_raw_plain(arc_c, 10, L, digest)),
        ))
    err["decode_raw"] = e6
    torch.cuda.empty_cache()

    # ---- 3. path K: the compressed collectives and the shard codec ----
    log("# phase 3: path K, the collectives and the shard codec at world size 1 over NCCL, "
        "on A's, B's and C's inputs")
    coll_rows = collectives_phase(port, inputs[0].view(torch.bfloat16),
                                  inputs_b[0].view(torch.float32), datas[0])
    torch.cuda.empty_cache()

    # ---- 3. paths D, E, F: the batched paths ----
    words_d, words_e, data_f, lengths_f = batch_inputs(dev)
    log(f"# phase 3: path D, bf16 batch of {BATCH} x {MEMBER_WORDS} words, prob_bits 10")
    bat = {"D": float_batch_path(port, "D", ft, words_d, err)}
    log(f"# phase 3: path E, f32 batch of {BATCH} x {MEMBER_WORDS} words, prob_bits 10")
    bat["E"] = float_batch_path(port, "E", F32, words_e, err)
    log(f"# phase 3: path F, raw ANS batch of {RAW_MEMBERS} members, "
        f"{sum(lengths_f)} bytes in [{RAW_CAP // 4}, {RAW_CAP}] each, prob_bits 10")
    bat["F"] = raw_batch_path(port, data_f, lengths_f, err)
    gh = api_paths(port, bat, words_d, data_f, lengths_f, err)
    hf = ragged_f32_path(port, gh["H"][1], dev, err)
    front_end = front_end_forms(port, bat, gh, words_d, data_f, lengths_f, card)
    err["split_f32_uniform"] = err_uniform
    log("# phase 3: path M, the decode kernel's descriptor form at path A's shape and at one "
        "expert layer's")
    mem = member_decode_phase(port, arc, size, n, Lw, ft, dev, err)

    launches = {}
    path_launches = {"A": launches_a, "B": launches_b, "C": launches_c, "J": launches_j,
                     **{p: st["launches"] for p, st in bat.items()},
                     "G": gh["G"][-1], "H": gh["H"][-1], "Hr": gh["Hr"][-1],
                     "Hf": hf["launches"]}
    for k, (_, _, _, path, kernel) in KERNELS.items():
        # path M's counts are each row's own call's
        launches[k] = (mem["launches"][k] if path == "M" else path_launches[path])[kernel]

    # ---- 4. timing ----
    log(f"# phase 4: timing, {ITERS} iterations, CUDA events; card: {card}")
    it = itertools.count()
    t_comp = time_ms(
        lambda: port.float_compress_padded(inputs[next(it) % 3], n, ft, 10, False),
        ITERS,
    )
    arcs = [port.float_compress_padded(w, n, ft, 10, False)[0] for w in inputs]
    t_dec = time_ms(
        lambda: port.float_decompress_padded(arcs[next(it) % 3], ft, Lw, 10, False,
                                             static_length=n),
        ITERS,
    )
    del arcs
    src = inputs[0]
    dst = torch.empty_like(src)
    t_copy = time_ms(lambda: dst.copy_(src), ITERS)
    del dst
    copy_gbps = 2 * raw_bytes / t_copy / 1e6
    # bound of either call: the input read once and the output written once
    call_bound_ms = (raw_bytes + size) / HBM_BYTES_PER_S * 1e3
    log(f"  compress   {raw_bytes / t_comp / 1e6:10.3f} GB/s  ({t_comp:.4f} ms; "
        f"bytes bound {call_bound_ms:.4f} ms)")
    log(f"  decompress {raw_bytes / t_dec / 1e6:10.3f} GB/s  ({t_dec:.4f} ms; "
        f"bytes bound {call_bound_ms:.4f} ms)")
    log(f"  copy_ of the {raw_bytes} input bytes: {t_copy:.4f} ms "
        f"({copy_gbps:.1f} GB/s read+write); bytes bound of a copy at 3.35 TB/s: "
        f"{2 * raw_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    t_plain = time_ms(
        lambda: cuda_decode.decode_float_plain(
            codec.float_compress_padded_plain(src, n, ft, 10, False)[0],
            ft, Lw, 10, n),
        1, warmup=0,
    )
    log(f"  plain pipeline (compress + decompress, plain versions on the card): {t_plain:.2f} ms")

    t_comp_b = time_ms(
        lambda: port.float_compress_padded(inputs_b[next(it) % 3], n, F32, 10, False),
        ITERS,
    )
    arcs = [port.float_compress_padded(w, n, F32, 10, False)[0] for w in inputs_b]
    t_dec_b = time_ms(
        lambda: port.float_decompress_padded(arcs[next(it) % 3], F32, Lw, 10, False,
                                             static_length=n),
        ITERS,
    )
    del arcs
    bound_b = (raw_b + size_b) / HBM_BYTES_PER_S * 1e3
    log(f"  path B compress   {raw_b / t_comp_b / 1e6:10.3f} GB/s  ({t_comp_b:.4f} ms; "
        f"bytes bound {bound_b:.4f} ms; ratio {size_b / raw_b:.6f})")
    log(f"  path B decompress {raw_b / t_dec_b / 1e6:10.3f} GB/s  ({t_dec_b:.4f} ms; "
        f"bytes bound {bound_b:.4f} ms)")
    t_enc_c = time_ms(lambda: port.ans_encode_padded(datas[next(it) % 3], L, 10, False), ITERS)
    arcs = [port.ans_encode_padded(d, L, 10, False)[0] for d in datas]
    t_dec_c = time_ms(lambda: port.ans_decode_padded(arcs[next(it) % 3], 10, L, False), ITERS)
    del arcs
    bound_c = (L + size_c) / HBM_BYTES_PER_S * 1e3
    log(f"  path C encode     {L / t_enc_c / 1e6:10.3f} GB/s  ({t_enc_c:.4f} ms; "
        f"bytes bound {bound_c:.4f} ms; ratio {size_c / L:.6f})")
    log(f"  path C decode     {L / t_dec_c / 1e6:10.3f} GB/s  ({t_dec_c:.4f} ms; "
        f"bytes bound {bound_c:.4f} ms)")

    # the batched paths, beside the same batch done as B single-tensor calls
    Lm = MEMBER_WORDS
    batch_calls = {
        "D": (lambda: port.float_compress_batched(words_d, Lm, ft, 10, False),
              lambda: port.float_decompress_batched(bat["D"]["arcs"], ft, Lm, 10, False,
                                                    static_length=Lm),
              lambda: [port.float_compress_padded(w, Lm, ft, 10, False) for w in words_d],
              lambda: [port.float_decompress_padded(a, ft, Lm, 10, False, static_length=Lm)
                       for a in bat["D"]["single"]],
              BATCH * Lm * 2),
        "E": (lambda: port.float_compress_batched(words_e, Lm, F32, 10, False),
              lambda: port.float_decompress_batched(bat["E"]["arcs"], F32, Lm, 10, False,
                                                    static_length=Lm),
              lambda: [port.float_compress_padded(w, Lm, F32, 10, False) for w in words_e],
              lambda: [port.float_decompress_padded(a, F32, Lm, 10, False, static_length=Lm)
                       for a in bat["E"]["single"]],
              BATCH * Lm * 4),
        "F": (lambda: port.ans_encode_batched(data_f, lengths_f, None, 10, False),
              lambda: port.ans_decode_batched(bat["F"]["arcs"], 10, RAW_CAP),
              lambda: [port.ans_encode_padded(d, m, 10, False) for d, m in zip(data_f, lengths_f)],
              lambda: [port.ans_decode_padded(a, 10, RAW_CAP, False) for a in bat["F"]["single"]],
              sum(lengths_f)),
    }
    for p, (comp, dec, comp1, dec1, raw) in batch_calls.items():
        t_c, t_d = time_ms(comp, ITERS), time_ms(dec, ITERS)
        t_c1, t_d1 = time_ms(comp1, 3, warmup=1), time_ms(dec1, 3, warmup=1)
        arc_bytes = int((bat[p]["sizes"] & 0x7FFFFFFF).sum())
        bound = (raw + arc_bytes) / HBM_BYTES_PER_S * 1e3
        log(f"  path {p} batched compress   {raw / t_c / 1e6:10.3f} GB/s  ({t_c:.4f} ms; "
            f"bytes bound {bound:.4f} ms; ratio {arc_bytes / raw:.6f})")
        log(f"  path {p} batched decompress {raw / t_d / 1e6:10.3f} GB/s  ({t_d:.4f} ms; "
            f"bytes bound {bound:.4f} ms)")
        log(f"  path {p} as single calls: compress {raw / t_c1 / 1e6:10.3f} GB/s "
            f"({t_c1:.4f} ms), decompress {raw / t_d1 / 1e6:10.3f} GB/s ({t_d1:.4f} ms)")
        torch.cuda.empty_cache()

    # the API paths and the joins
    from dietgpu_tpu_torch import api, torch_api

    ts_g, outs_g, comp_g, sizes_g, _ = gh["G"]
    rows_g = [comp_g[b, :s] for b, s in enumerate(sizes_g.tolist())]
    t_c = time_ms(lambda: torch_api.compress_data(True, ts_g), ITERS)
    t_d = time_ms(lambda: torch_api.decompress_data(True, rows_g, outs_g), ITERS)
    raw = BATCH * MEMBER_WORDS * 2
    log(f"  path G torch_api compress   {raw / t_c / 1e6:10.3f} GB/s  ({t_c:.4f} ms)")
    log(f"  path G torch_api decompress {raw / t_d / 1e6:10.3f} GB/s  ({t_d:.4f} ms, in place)")
    ts_h, lens_h, comp_h, sizes_h, _ = gh["H"]
    rows_h = [comp_h[b, :s] for b, s in enumerate(sizes_h.tolist())]
    t_c = time_ms(lambda: api.compress_data(True, ts_h), ITERS)
    t_d = time_ms(lambda: api.decompress_data(True, rows_h, ts_h), ITERS)
    raw = 2 * sum(lens_h)
    arc_bytes = int(sizes_h.sum())
    log(f"  path H api compress   {raw / t_c / 1e6:10.3f} GB/s  ({t_c:.4f} ms; "
        f"bytes bound {(raw + arc_bytes) / HBM_BYTES_PER_S * 1e3:.4f} ms; "
        f"ratio {arc_bytes / raw:.6f})")
    log(f"  path H api decompress {raw / t_d / 1e6:10.3f} GB/s  ({t_d:.4f} ms)")
    ts_r, comp_r, sizes_r, _ = gh["Hr"]
    rows_r = [comp_r[b, :s] for b, s in enumerate(sizes_r.tolist())]
    t_c = time_ms(lambda: api.compress_data(False, ts_r), ITERS)
    t_d = time_ms(lambda: api.decompress_data(False, rows_r, ts_r), ITERS)
    raw = sum(lengths_f)
    log(f"  path Hr api compress   {raw / t_c / 1e6:10.3f} GB/s  ({t_c:.4f} ms)")
    log(f"  path Hr api decompress {raw / t_d / 1e6:10.3f} GB/s  ({t_d:.4f} ms)")
    del rows_g, rows_h, rows_r
    torch.cuda.empty_cache()
    t_j = time_ms(lambda: port.join_words_packed(e_j, c_j, ft), ITERS)
    t_j32 = time_ms(lambda: port.join_words_packed_f32(e32_j, lo_j, hi_j), ITERS)
    log(f"  path J join     {raw_bytes / t_j / 1e6:10.3f} GB/s of words  ({t_j:.4f} ms)")
    log(f"  path J join_f32 {raw_b / t_j32 / 1e6:10.3f} GB/s of words  ({t_j32:.4f} ms)")

    counts = ke[1].long()
    emitted = int(counts.sum())
    padded_words = int(((counts + 7) // 8 * 8).clamp(max=2560).sum())
    NB = Lw // C.DEFAULT_BLOCK_SIZE
    work = {  # (bytes each input read once + each output written once, symbols)
        "split": (4 * Lw + 4 * 256, Lw),
        "encode": (Lw + 2048 + 2 * emitted + 4 * NB + 128 * NB, n),
        "assembly": (4 * padded_words + 8 * NB, 0),
        # counts read, weights written, table written
        "tables": (4 * 256 + 4 * 256 + 4 * 512, 0),
        # counts and states read; states, blockWords, prefix, header and
        # probs written; weights read
        "sections": (NB * (4 + 128 + 128 + 8 + 4) + 4 * 136 + 4 * 256, 0),
        "decode": (size + 2 * Lw, n),
        "hist": (L + 4 * 256, L),
        "decode_raw": (size_c + L, L),
        "split_f32": (8 * Lw + 4 * 256, Lw),
        "decode_f32": (size_b + 4 * Lw, n),
        # the batched kernels at paths D, E and F's shapes
        "split_batched": (BATCH * (4 * Lm + 4 * 256), BATCH * Lm),
        "encode_batched": (BATCH * (Lm + 2048 + 132 * (Lm // 4096)) + 2 * bat["D"]["emitted"],
                           BATCH * Lm),
        "assembly_batched": (4 * bat["D"]["padded_words"] + 8 * BATCH * (Lm // 4096 + 1), 0),
        "decode_batched": (int(bat["D"]["sizes"].sum()) + 2 * BATCH * Lm, BATCH * Lm),
        "split_f32_batched": (BATCH * (8 * Lm + 4 * 256), BATCH * Lm),
        "decode_f32_batched": (int(bat["E"]["sizes"].sum()) + 4 * BATCH * Lm, BATCH * Lm),
        "hist_batched": (sum(lengths_f) + RAW_MEMBERS * (8 + 4 * 256), sum(lengths_f)),
        "decode_raw_batched": (int(bat["F"]["sizes"].sum()) + RAW_MEMBERS * RAW_CAP,
                               sum(lengths_f)),
        # the split at path H's ragged lengths: each member's words read,
        # both full planes written; the joins at path J's shapes
        "split_ragged": (2 * sum(lens_h) + RAGGED_MEMBERS * (2 * member_width(lens_h) + 4 * 256),
                         RAGGED_MEMBERS * member_width(lens_h)),
        "join": (4 * n, n),
        "join_f32": (8 * n, n),
        # split_f32 on uniformly random words at path B's size, and in
        # container mode at path H's lengths (each member's words read, its
        # exponent plane at full width, its low and high planes to their
        # archived ends)
        "split_f32_uniform": (8 * Lw + 4 * 256, Lw),
        "split_f32_ragged": hf["work"],
        **mem["work"],
    }
    wb = inputs_b[0]
    wu = uniform_words(dev, (1, n), 10)  # phase2_slice10's 128Mi uniform words
    runs = {
        "split": (lambda: cuda_float.split_words_batched_cuda(pairs[None], n, ft),
                  lambda: cuda_float.split_words_plain(pairs, n, ft)),
        "encode": (lambda: cuda_encode.encode_blocks_batched_cuda(exp32, n, 10, table),
                   lambda: plain_encode.encode_blocks_batched(exp32, n, 10, table)),
        "assembly": (
            lambda: cuda_encode.assemble_payload_batched_cuda(asm_k, ds32, ke[0], ke[1], prefix),
            lambda: plain_encode.assemble_payload_batched(asm_k, ds32, ke[0], ke[1], prefix)),
        "tables": (lambda: cuda_encode.quantize_cuda(hist_a, n, 10),
                   lambda: plain_encode.encode_table(stats.normalize_probs(ks[2], n, 10))),
        # the same words again into path A's archive buffer
        "sections": (
            lambda: cuda_encode.write_sections_batched_cuda(asm_k, base32, kt[0], ke[2], ke[1],
                                                            [n], 10),
            lambda: plain_encode.write_sections_batched(asm_k, base32, pdf[None], ke[2], ke[1],
                                                        [n], 10)),
        "decode": (lambda: cuda_decode.decode_float(arc, ft, Lw, 10, n),
                   lambda: cuda_decode.decode_float_plain(arc, ft, Lw, 10, n)),
        "hist": (lambda: cuda_hist.histogram_u8_batched_cuda(d32c[None], [L]),
                 lambda: cuda_hist.histogram_u8_plain(d32c, L)),
        "decode_raw": (lambda: cuda_decode.decode_raw_batched_cuda(arc_c[None], 10, L),
                       lambda: cuda_decode.decode_raw_plain(arc_c, 10, L)),
        "split_f32": (lambda: cuda_float.split_words_f32_batched_cuda(wb[None], n),
                      lambda: cuda_float.split_words_f32_plain(wb, n)),
        "decode_f32": (lambda: cuda_decode.decode_float(arc_b, F32, Lw, 10, n),
                       lambda: cuda_decode.decode_float_plain(arc_b, F32, Lw, 10, n)),
        "split_batched": bat["D"]["split"],
        "encode_batched": bat["D"]["encode"],
        "assembly_batched": bat["D"]["assembly"],
        "decode_batched": bat["D"]["decode"],
        "split_f32_batched": bat["E"]["split"],
        "decode_f32_batched": bat["E"]["decode"],
        "hist_batched": bat["F"]["hist"],
        "decode_raw_batched": bat["F"]["decode"],
        "split_ragged": gh["split"],
        "join": (lambda: cuda_float.join_words_cuda(e_j[None], c_j[None], ft),
                 lambda: cuda_float.join_words_plain(e_j[None], c_j[None], ft)),
        "join_f32": (lambda: cuda_float.join_words_f32_cuda(e32_j[None], lo_j[None], hi_j[None]),
                     lambda: cuda_float.join_words_f32_plain(e32_j[None], lo_j[None],
                                                             hi_j[None])),
        "split_f32_uniform": (lambda: cuda_float.split_words_f32_batched_cuda(wu, n),
                              lambda: cuda_float.split_words_f32_plain(wu[0], n)),
        "split_f32_ragged": hf["split"],
        **mem["runs"],
    }
    # one torch call computing the same function, where there is one
    library = {"hist": lambda: torch.bincount(datas[0], minlength=256)}
    rows = []
    for k, (source, replaces, ops_per, _, _) in KERNELS.items():
        nbytes, nsym = work[k]
        ms = (graph_ms if k in GRAPH_TIMED else time_ms)(runs[k][0], ITERS)
        plain_ms = time_ms(runs[k][1], 1, warmup=0)
        library_ms = time_ms(library[k], ITERS) if k in library else None
        torch.cuda.empty_cache()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_per * nsym / INT_OPS_PER_S * 1e3
        rows.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[k], "max_abs_err": err[k], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "timed": "graph" if k in GRAPH_TIMED else "eager",
        })
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        log(f"  {k:18s} {ms:9.4f} ms  bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({nbytes} B)  plain {plain_ms:9.2f} ms  launches {launches[k]}{lib}")
    del runs, wu, mem
    torch.cuda.empty_cache()

    # ---- 4. captured: each path's calls in a CUDA graph ----
    log(f"# phase 4: captured, each path's compress and decompress in a CUDA graph, replayed "
        f"on 3 inputs; card: {card}")
    ts_h, lens_h = gh["H"][:2]
    W = member_width(lens_h)
    words_h = torch.zeros((RAGGED_MEMBERS, W), dtype=torch.int16, device=dev)
    for m, t in enumerate(ts_h):
        words_h[m, : lens_h[m]] = t.view(torch.int16)

    def float_calls(raw, xs, length, ft_, Lw_, static, kernels, dec_kernels, batched):
        comp_fn = port.float_compress_batched if batched else port.float_compress_padded
        dec_fn = port.float_decompress_batched if batched else port.float_decompress_padded
        want = [x.view(torch.int32) for x in xs]
        return [
            ("compress", raw, lambda w: comp_fn(w, length, ft_, 10, False), [(x,) for x in xs],
             archive_view, kernels, None),
            ("decompress", raw,
             lambda a: dec_fn(a, ft_, Lw_, 10, False, static_length=static),
             lambda ev: [(a,) for a, _ in ev], result_view, dec_kernels,
             lambda k, r: bool(r["success"].all()) and torch.equal(r["out32"], want[k])),
        ]

    def raw_calls(raw, xs, length, cap, batched):
        comp_fn = ((lambda d: port.ans_encode_batched(d, length, None, 10, False)) if batched
                   else (lambda d: port.ans_encode_padded(d, length, 10, False)))
        dec_fn = port.ans_decode_batched if batched else port.ans_decode_padded
        return [
            ("compress", raw, comp_fn, [(x,) for x in xs], archive_view, "raw", None),
            ("decompress", raw, lambda a: dec_fn(a, 10, cap), lambda ev: [(a,) for a, _ in ev],
             result_view, "decode_raw",
             lambda k, r: bool(r["success"].all()) and torch.equal(r["out"], xs[k])),
        ]

    def join_calls():
        half = [one(cuda_float.split_words_batched_cuda(w[None], n, ft))[:2] for w in inputs]
        full = [one(cuda_float.split_words_f32_batched_cuda(w[None], n))[:3] for w in inputs_b]
        return [
            ("join", raw_bytes, lambda e, c: port.join_words_packed(e, c, ft), half,
             lambda r: [r], "join", lambda k, r: torch.equal(r, inputs[k])),
            ("join_f32", raw_b, port.join_words_packed_f32, full, lambda r: [r], "join_f32",
             lambda k, r: torch.equal(r, inputs_b[k])),
        ]

    Lm = MEMBER_WORDS
    captured = captured_phase(port, card, {
        "A": lambda: float_calls(raw_bytes, inputs, n, ft, Lw, n, "float", "decode", False),
        "B": lambda: float_calls(raw_b, inputs_b, n, F32, Lw, n, "float32", "decode_f32", False),
        "C": lambda: raw_calls(L, datas, L, L, False),
        "D": lambda: float_calls(BATCH * Lm * 2, variants(words_d), Lm, ft, Lm, Lm, "float",
                                 "decode", True),
        "E": lambda: float_calls(BATCH * Lm * 4, variants(words_e), Lm, F32, Lm, Lm, "float32",
                                 "decode_f32", True),
        "F": lambda: raw_calls(sum(lengths_f), variants(data_f, lengths_f), lengths_f, RAW_CAP,
                               True),
        "H": lambda: float_calls(2 * sum(lens_h), variants(words_h, lens_h), lens_h, ft, W, None,
                                 "float", "decode", True),
        "Hf": lambda: float_calls(4 * sum(lens_h), variants(hf["words"], lens_h), lens_h, F32, W,
                                  None, "float32", "decode_f32", True),
        "J": join_calls,
    })
    del words_h, hf
    torch.cuda.empty_cache()

    # ---- 5. path L: a GPT-2 XL checkpoint; path A's stages ----
    ckpt = checkpoint_path(port, dev, card, inputs[0], arc, size)
    torch.cuda.empty_cache()
    log("# phase 5: path A's stages, one compress and one decompress under the profiler")
    stage_rows = stages_phase(port, inputs[0], n, Lw, ft)

    for m in list(sys.modules):
        if m.split(".")[0] in ("jax", "jaxlib", "dietgpu_tpu", "ml_dtypes"):
            raise AssertionError(f"{m} was imported")
    log(f"# total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"collectives": {
        "world_size": 1, "backend": "nccl", "card": card,
        "measures": "world size 1: each exchange is a copy on the card, so ms is the codec's "
                    "cost beside the raw call's, not a wire saving",
        "rows": coll_rows}}))
    print(json.dumps({"checkpoint": ckpt}))
    print(json.dumps({"stages": {
        "path": "A", "calls": "one float_compress_padded and one float_decompress_padded",
        "card": card, "rows": stage_rows}}))
    print(json.dumps({"front_end": {"paths": "G, Gs", "card": card, "rows": front_end}}))
    print(json.dumps({"captured": {
        "card": card, "inputs": 3, "iters": ITERS,
        "measures": "eager_ms: the call as a user makes it; replay_ms: one replay of its CUDA "
                    "graph, captured once after an eager warm-up (CUDA events, ITERS calls)",
        "rows": captured}}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
