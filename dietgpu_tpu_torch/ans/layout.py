"""Byte <-> u32 views, the u32 conventions of the port, and the members'
lengths as the batched kernels take them.

torch has no full uint32 arithmetic, so the port stores u32 data as int32
bit patterns (what the kernels read as ``uint32_t``) and computes on it in
int64 masked to 32 bits. The byte <-> word conversions are zero-copy
little-endian ``Tensor.view`` reinterpretations (the card and the CPUs the
tests run on are little-endian).
"""

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
    on the card): `lengths_t` if the caller has one, or made here. The
    caller holds the returned tensor until the launch, so that the
    allocator cannot hand its memory to another tensor first."""
    if all(n == lengths[0] for n in lengths):
        return lengths[0], None
    if lengths_t is None:
        lengths_t = torch.tensor(lengths, dtype=torch.int64, device=dev)
    _build.check_cuda_tensor(lengths_t, what, torch.int64, len(lengths), align=8)
    return 0, lengths_t


def data_ptr(t):
    """A tensor's device address for a kernel argument, None for None."""
    return None if t is None else t.data_ptr()
