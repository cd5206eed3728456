"""The byte histogram kernel (``csrc/hist.cu``) and its plain version.

Counterpart of ``dietgpu_tpu.ans.pallas_hist.histogram_u8_pallas`` and of
the routed ``dietgpu_tpu.backend.histogram_u8``: the exact 256-bin
histogram of the first `length` bytes of a packed little-endian byte
stream, with the folded XOR checksum of the same bytes fused into the pass.

A CUDA tensor goes through the kernel; a CPU tensor through the plain
version. The kernel gives each row of a (B, n4) batch its own length,
histogram and checksum, in one launch (counterpart of the vmapped
``histogram_u8_pallas`` of the JAX package's one-grid batch encode); a
single stream is a batch of one.
"""

import torch

from .. import _build
from .. import constants as C
from . import checksum, layout, stats


def _check(data32: torch.Tensor, length: int):
    if data32.dtype != torch.int32 or data32.dim() != 1:
        raise ValueError("histogram: data must be 1-D int32 packed bytes")
    if not 0 <= length <= 4 * data32.shape[0]:
        raise ValueError(f"histogram: length {length} outside [0, {4 * data32.shape[0]}]")


def histogram_u8_plain(data32, length, with_checksum=False):
    """Plain torch version of the histogram kernel.

    (n4,) int32 packed bytes -> (hist (256,) int32, checksum int32 0-dim):
    the counts of the first `length` bytes, and the folded XOR of the same
    bytes when `with_checksum`, else 0.
    """
    _check(data32, length)
    data8 = layout.u32_to_u8le(data32)
    hist = stats.histogram_u8(data8, length).to(torch.int32)
    cks = (
        checksum.checksum_u8(data8, length)
        if with_checksum
        else torch.zeros((), dtype=torch.int64, device=data32.device)
    ).to(torch.int32)
    return hist, cks


def _check_batched(data32, lengths):
    if data32.dtype != torch.int32 or data32.dim() != 2:
        raise ValueError("histogram: a batch is (B, n4) int32 packed bytes")
    return layout.member_lengths(lengths, data32.shape[0], 4 * data32.shape[1], "histogram")


def histogram_u8_batched_plain(data32, lengths, with_checksum=False, lengths_t=None):
    """Plain version of the batched histogram kernel: :func:`histogram_u8_plain`
    of each row of `data32` ((B, n4) int32) with its own length (B host
    ints). Returns (hist (B, 256) int32, checksums (B,) int32).
    `lengths_t` is the kernel's device copy of the lengths; the plain
    version does not need it."""
    lengths = _check_batched(data32, lengths)
    out = [histogram_u8_plain(d, n, with_checksum) for d, n in zip(data32, lengths)]
    return torch.stack([h for h, _ in out]), torch.stack([c for _, c in out])


def histogram_u8_batched_cuda(data32, lengths, with_checksum=False, lengths_t=None):
    """Launch ``csrc/hist.cu``, one launch for all B rows; same contract as
    :func:`histogram_u8_batched_plain`. The kernel takes one length when
    they are all equal, else their (B,) int64 copy on the card:
    `lengths_t`, or made here. Each row must be a multiple of 16 bytes."""
    lengths = _check_batched(data32, lengths)
    _build.check_cuda_tensor(data32, "histogram data", torch.int32)
    if data32.shape[1] % 4:
        raise ValueError("histogram: the kernel needs rows of a multiple of 16 bytes")
    B = data32.shape[0]
    dev = data32.device
    n, n_t = layout.device_lengths(lengths, lengths_t, dev, "histogram lengths")
    hist = torch.zeros((B, C.NUM_SYMBOLS), dtype=torch.int32, device=dev)
    cks = torch.zeros(B, dtype=torch.int32, device=dev)
    _build.launch(
        "hist", data32.data_ptr(), B, data32.shape[1] // 4, n, layout.data_ptr(n_t),
        sum((x + 15) // 16 for x in lengths), hist.data_ptr(),
        cks.data_ptr() if with_checksum else None, data32.shape[1],
    )
    return hist, cks


def histogram_u8(data: torch.Tensor, length: int, with_checksum: bool = False):
    """Exact 256-bin histogram of the first `length` bytes of `data`.

    `data` is (L,) uint8 or the same bytes packed little-endian as (L/4,)
    int32. Returns (256,) int32 counts, or (counts, checksum) with
    `with_checksum` (the folded 8-bit XOR of the same bytes, int32 0-dim),
    on the device of `data`.
    """
    if data.dim() != 1:
        raise ValueError("histogram: data must be 1-D")
    if data.dtype == torch.int32:
        data8 = data.view(torch.uint8)
    elif data.dtype == torch.uint8:
        data8 = data
    else:
        raise ValueError(f"histogram: unsupported dtype {data.dtype}")
    if not 0 <= length <= data8.shape[0]:
        raise ValueError(f"histogram: length {length} outside [0, {data8.shape[0]}]")
    pad = (-data8.shape[0]) % 16
    if pad:  # whole 16-byte groups for the kernel
        data8 = torch.cat([data8, data8.new_zeros(pad)])
    data32 = layout.u8_to_u32le(data8.contiguous())
    if data32.is_cuda:
        hist, cks = (x[0] for x in histogram_u8_batched_cuda(data32[None], [length],
                                                               with_checksum))
    else:
        hist, cks = histogram_u8_plain(data32, length, with_checksum)
    return (hist, cks) if with_checksum else hist
