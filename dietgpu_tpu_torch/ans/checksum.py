"""Folded XOR checksum (torch).

The XOR of every byte of the input, as in the reference's vectorized u32
XOR plus byte fold (GpuChecksum.cuh:27-93): XOR all u32 words, then fold
the four byte lanes. The fold is linear over XOR, so partial accumulators
may be folded before they are combined (the CUDA kernels do).
"""

import torch

from . import layout


def _fold8(x: torch.Tensor) -> torch.Tensor:
    """Fold a u32 XOR accumulator to the 8-bit checksum (int64)."""
    x = layout.to_u32(x)
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    return x & 0xFF


def xor_reduce(w: torch.Tensor) -> torch.Tensor:
    """XOR of the elements of an integer tensor along its last dim (int64,
    low 32 bits; 0-dim for a 1-D tensor)."""
    w = layout.to_u32(w)
    while w.shape[-1] > 1:
        if w.shape[-1] & 1:
            w = torch.cat([w, w.new_zeros(*w.shape[:-1], 1)], -1)
        w = w[..., 0::2] ^ w[..., 1::2]
    if w.shape[-1]:
        return w[..., 0]
    return torch.zeros(w.shape[:-1], dtype=torch.int64, device=w.device)


def checksum_u32(words: torch.Tensor, length_bytes: int) -> torch.Tensor:
    """Checksum of the first `length_bytes` bytes of a packed little-endian
    u32 byte stream (int32 words). Returns the folded 8-bit value (int64)."""
    assert words.dtype == torch.int32
    n4 = words.shape[0]
    nb = max(0, min(int(length_bytes), 4 * n4))
    w = layout.to_u32(words)
    idx = torch.arange(n4, device=words.device)
    bmask = (1 << (8 * (nb & 3))) - 1
    w = torch.where(
        idx < (nb >> 2), w, torch.where(idx == (nb >> 2), w & bmask, 0)
    )
    return _fold8(xor_reduce(w))


def checksum_u8(data: torch.Tensor, length: int) -> torch.Tensor:
    """XOR of data[:length] bytes (int64). `data` is 1-D uint8."""
    assert data.dtype == torch.uint8
    n = data.shape[0]
    if n % 4:
        data = torch.cat([data, data.new_zeros((-n) % 4)])
    return checksum_u32(layout.u8_to_u32le(data), min(int(length), n))


def checksum_rows(data: torch.Tensor, lengths) -> torch.Tensor:
    """Checksum of each row's first lengths[m] bytes of (B, L) uint8, L % 4
    == 0; `lengths` is B host ints, clamped to [0, L]. Returns (B,) int64."""
    assert data.dtype == torch.uint8 and data.dim() == 2 and data.shape[1] % 4 == 0
    n = torch.tensor(lengths, dtype=torch.int64, device=data.device)[:, None]
    keep = torch.arange(data.shape[1], device=data.device)[None, :] < n
    masked = torch.where(keep, data, torch.zeros((), dtype=torch.uint8, device=data.device))
    return _fold8(xor_reduce(masked.view(torch.int32)))


def verified(pair: torch.Tensor, digest: torch.Tensor) -> torch.Tensor:
    """Whether each decoded output passes its archive's stored checksum:
    `pair` holds each archive's option word and stored checksum ((..., 2)
    int32 u32 words), `digest` the output's folded XOR (...). An archive
    whose options carry no checksum (bit 0x10 clear) passes."""
    opts, stored = layout.to_u32(pair).unbind(-1)
    return ((opts & 0x10) == 0) | (digest == stored)
