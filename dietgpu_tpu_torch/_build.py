"""Builds the CUDA kernels of ``csrc/`` on first use and binds them.

Each ``csrc/<source>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/`` at the
root of the checkout, named by the hash of its source and of the headers
it may include (``csrc/*.cuh``), then loaded with ctypes. All sources are
compiled in parallel, one ``nvcc`` each. Nothing is built when the package
is imported. A source may hold several kernels
(``decode.cu`` holds the f16/bf16, f32 and raw-byte configurations of the
decode kernel behind one C entry point; ``join.cu`` the two joins and
``assembly.cu`` the assembly and sections kernels, one entry point each),
each kernel with its own launch counter, launched through ``launch.cuh``.
Every kernel takes a batch of members and is launched once for the whole
batch; a single tensor is a batch of one.

Every wrapper launches through :func:`launch`, which checks the returned
``cudaGetLastError()`` and counts the launch in ``profiling``'s registry
as ``launch.<kernel>``; :func:`kernel_launches` reads the counts.

A CUDA graph capture (``torch.cuda.graph``) records the launches of a call
on the card: the C entry points enqueue nothing but their kernel, and
their other calls (the current device, the last error) are host queries,
legal while a stream captures. A kernel is built and loaded, and its
launch shape asked of the runtime, at its first launch, which must come
before any capture: the warm-up call that a capture needs anyway. A launch
counts once, when it is made, so a capture adds its launches to the counts
once and a replay adds nothing.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("split", "split_f32", "hist", "stats", "encode", "assembly", "decode", "join")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
# the decode's three configurations: one entry point, a launch counter each
_DECODE = ("decode", "dtt_decode",
           (_VP, _LL, _LL, _VP, _INT, _INT, _INT, _LL, _LL, _INT, _VP, _VP, _VP, _INT))
# kernel (one launch counter each) -> (source, C entry point, argument types
# before the stream, which every entry point takes last). Every entry point
# takes a batch of members; a single tensor is a batch of one.
_ENTRY = {
    "split": (
        "split", "dtt_split",
        (_VP, _LL, _LL, _LL, _VP, _LL, _INT, _VP, _VP, _VP, _VP, _LL, _LL, _LL),
    ),
    "split_f32": (
        "split_f32", "dtt_split_f32",
        (_VP, _LL, _LL, _LL, _VP, _LL, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL),
    ),
    "hist": ("hist", "dtt_hist", (_VP, _LL, _LL, _LL, _VP, _LL, _VP, _VP, _LL)),
    "tables": ("stats", "dtt_tables", (_VP, _VP, _LL, _LL, _VP, _INT, _VP, _VP)),
    "encode": ("encode", "dtt_encode", (_VP, _LL, _LL, _LL, _VP, _INT, _VP, _VP, _VP, _VP)),
    "sections": (
        "assembly", "dtt_sections", (_VP, _VP, _VP, _VP, _VP, _LL, _LL, _VP, _LL, _VP, _VP),
    ),
    "assembly": ("assembly", "dtt_assemble", (_VP, _VP, _VP, _LL, _LL, _VP, _LL, _LL, _VP)),
    "decode": _DECODE,
    "decode_f32": _DECODE,
    "decode_raw": _DECODE,
    "join": ("join", "dtt_join", (_VP, _VP, _LL, _LL, _INT, _VP, _LL, _LL, _LL)),
    "join_f32": ("join", "dtt_join_f32", (_VP, _VP, _VP, _LL, _LL, _VP, _LL, _LL, _LL, _LL)),
}
KERNELS = tuple(_ENTRY)
# kernel -> (source, C entry point, configuration) of the entry that reports
# its resources (launch.cuh: its attributes and occupancy at its launch shape)
_RESOURCES = {
    "split": ("split", "dtt_split_resources", 0),
    "split_f32": ("split_f32", "dtt_split_f32_resources", 0),
    "hist": ("hist", "dtt_hist_resources", 0),
    "tables": ("stats", "dtt_tables_resources", 0),
    "sections": ("assembly", "dtt_sections_resources", 0),
    "encode": ("encode", "dtt_encode_resources", 0),
    "decode": ("decode", "dtt_decode_resources", 0),
    "decode_f32": ("decode", "dtt_decode_resources", 1),
    "decode_raw": ("decode", "dtt_decode_resources", 2),
    "join": ("join", "dtt_join_resources", 0),
    "join_f32": ("join", "dtt_join_resources", 1),
}
RESOURCE_FIELDS = ("registers", "static_smem", "dynamic_smem", "local_bytes", "threads",
                   "ctas_per_sm")

_LAUNCH_COUNTER = {k: "launch." + k for k in KERNELS}  # kernel -> its counter
_entries = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the headers a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.

    Returns {source: seconds} for the ones compiled. Raises with nvcc's
    output when a build fails.
    """
    todo = [k for k in SOURCES if not _lib_path(k).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        )
    times, errors = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return times


def _entry(name: str):
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"kernel '{name}' is not loaded: make one call outside the capture first")
            build_all()
            source, sym, argtypes = _ENTRY[name]
            fn = getattr(ctypes.CDLL(str(_lib_path(source))), sym)
            fn.argtypes = (*argtypes, _VP)
            fn.restype = ctypes.c_int
            _entries[name] = fn
        return fn


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream; raise if it was refused.
    Counts the launch; under a CUDA graph capture the launch is recorded,
    counted once, and each replay of the graph runs it without counting."""
    fn = _entry(name)
    # ctypes passes arguments past argtypes unchecked, as C ints
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"kernel '{name}' takes {len(fn.argtypes) - 1} arguments, got {len(args)}")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: cudaError {rc}")
    profiling.count(_LAUNCH_COUNTER[name])


def kernel_resources(name: str) -> dict:
    """What kernel `name` takes on the card: registers a thread, static and
    dynamic shared bytes a CTA, local (spill) bytes a thread, threads a CTA
    and CTAs per SM at its launch shape, {field: int}."""
    source, sym, config = _RESOURCES[name]
    with _lock:
        build_all()
        fn = getattr(ctypes.CDLL(str(_lib_path(source))), sym)
    fn.argtypes = (_INT, ctypes.POINTER(_INT))
    fn.restype = ctypes.c_int
    out = (_INT * len(RESOURCE_FIELDS))()
    rc = fn(config, out)
    if rc != 0:
        raise RuntimeError(f"resources of CUDA kernel '{name}': cudaError {rc}")
    return dict(zip(RESOURCE_FIELDS, out))


def kernel_launches() -> dict:
    """Launches of each kernel since the last reset, {name: count}: the
    launches made by eager calls and recorded by captures, not those that
    replays of a CUDA graph run."""
    return {k: profiling.counter(c) for k, c in _LAUNCH_COUNTER.items()}


def reset_kernel_launches() -> None:
    profiling.reset_counters(_LAUNCH_COUNTER.values())


def check_cuda_tensor(t: torch.Tensor, what: str, dtype, numel=None, align=16):
    """Validate a tensor handed to a kernel (device, dtype, layout, size)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{what}: expected {numel} elements, got {t.numel()}")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: data must be {align}-byte aligned")
