"""Byte <-> u32 views, the u32 conventions of the port, the members'
lengths as the batched kernels take them, and the cache of the geometry
that the entry points take from host ints.

torch has no full uint32 arithmetic, so the port stores u32 data as int32
bit patterns (what the kernels read as ``uint32_t``) and computes on it in
int64 masked to 32 bits. The byte <-> word conversions are zero-copy
little-endian ``Tensor.view`` reinterpretations (the card and the CPUs the
tests run on are little-endian).

The codec's entry points read nothing back from the card and copy nothing
from pageable memory, so that a CUDA graph can capture them
(``torch.cuda.graph``): scalars are fills, and what B host ints define (a
ragged batch's lengths, its archive offsets, the section words) comes from
:func:`device_constant`, made by the first call with those ints (the
warm-up) and read, never written, by every later one. It is the
counterpart of the JAX API's ``functools.lru_cache`` of jitted programs
(``dietgpu_tpu/api.py``), whose compiled constants live as long as the
program.
"""

from collections import OrderedDict

import numpy as np
import torch

from .. import _build

U32_MASK = 0xFFFFFFFF


def u8_to_u32le(x: torch.Tensor) -> torch.Tensor:
    """(4n,) uint8 -> (n,) int32 holding the little-endian u32 words."""
    assert x.dtype == torch.uint8 and x.dim() == 1 and x.shape[0] % 4 == 0
    return x.view(torch.int32)


def u32_to_u8le(w: torch.Tensor) -> torch.Tensor:
    """(n,) int32 u32 words -> (4n,) uint8 little-endian bytes."""
    assert w.dtype == torch.int32 and w.dim() == 1
    return w.view(torch.uint8)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of `t`, flat (a view where `t` is contiguous)."""
    t = t.reshape(-1)
    if t.dtype == torch.uint8:
        return t
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.view(torch.uint8)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits as unsigned."""
    return x.to(torch.int64) & U32_MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> the int32 tensor with those bits."""
    x = x.to(torch.int64) & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def as_i32(v: int) -> int:
    """A u32 Python int read as the signed int32 it is in the JAX package."""
    v &= U32_MASK
    return v - (1 << 32) if v >= 1 << 31 else v


def member_lengths(length, B: int, limit: int, what: str) -> list:
    """B host ints from `length` (one int for every member, or B ints),
    each in [0, limit]."""
    lengths = [int(n) for n in length] if hasattr(length, "__len__") else [int(length)] * B
    if len(lengths) != B or not all(0 <= n <= limit for n in lengths):
        raise ValueError(f"{what}: need {B} lengths in [0, {limit}]")
    return lengths


def device_lengths(lengths: list, lengths_t, dev, what: str):
    """What a batched kernel takes for the members' lengths: (the one
    length, None) when they are all equal, else (0, their (B,) int64 copy
    on the card): `lengths_t` if the caller has one, or
    :func:`lengths_tensor`'s. The caller holds the returned tensor until
    the launch, so that the allocator cannot hand its memory to another
    tensor first."""
    if all(n == lengths[0] for n in lengths):
        return lengths[0], None
    if lengths_t is None:
        lengths_t = lengths_tensor(lengths, dev)
    _build.check_cuda_tensor(lengths_t, what, torch.int64, len(lengths), align=8)
    return 0, lengths_t


# Entries made by eager calls, least recently used first; at most
# _CACHE_ENTRIES of them, so that a process whose calls see ever new ragged
# lengths (the API's callers) holds a bounded number (a few hundred bytes a
# member each). An entry that a capture has read moves to _captured and
# stays for the life of the process: the graph reads its memory at every
# replay, and nothing tells the cache when the graph is gone.
_CACHE_ENTRIES = 64
_cache = OrderedDict()
_captured = {}


def device_constant(key, dev, make):
    """The int64 tensor on `dev` that holds ``make()`` (a numpy array),
    made once for (`dev`, `key`) and read-only: callers build what they
    write from it into fresh tensors.

    `key` is hashable and names everything that ``make()`` depends on. On
    the card the first call for a key copies through pinned memory
    without a stream sync; a later call on another stream waits for that
    copy. Inside a CUDA graph capture only a key made before the capture
    can be read: any other raises RuntimeError, since the copy would need
    host memory that outlives the graph.
    """
    k = (dev, key)
    cuda = dev.type == "cuda"
    capturing = cuda and torch.cuda.is_current_stream_capturing()
    entry = _captured.get(k)
    if entry is None:
        entry = _cache.get(k)
        if entry is None:
            if capturing:
                raise RuntimeError(
                    "device geometry for these lengths was not made before the capture: "
                    "make one call with the same arguments outside the capture first")
            host = torch.from_numpy(np.ascontiguousarray(make(), np.int64))
            if cuda:
                ready = torch.cuda.Event()
                entry = (host.pin_memory().to(dev, non_blocking=True), ready)
                ready.record()
            else:
                entry = (host.to(dev), None)
            _cache[k] = entry
            if len(_cache) > _CACHE_ENTRIES:
                _cache.popitem(last=False)
        else:
            _cache.move_to_end(k)
        if capturing:
            _captured[k] = _cache.pop(k)
    t, ready = entry
    if cuda and not capturing:
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(ready)
        t.record_stream(stream)
    return t


def ints_key(values):
    """A short hashable key for B ints: the count and the value when they
    are all equal (the common batch), else all of them."""
    v = np.asarray(values, np.int64)
    if (v == v[0]).all():
        return "all", len(v), int(v[0])
    return "each", tuple(v.tolist())


def lengths_tensor(lengths, dev):
    """The members' lengths (B host ints) as a read-only (B,) int64
    tensor on `dev`, from :func:`device_constant`."""
    return device_constant(("lengths", tuple(lengths)), dev, lambda: np.asarray(lengths))


def data_ptr(t):
    """A tensor's device address for a kernel argument, None for None."""
    return None if t is None else t.data_ptr()
