"""The float split kernels (``csrc/split.cu``, ``csrc/split_f32.cu``) and
their plain versions.

Counterpart of ``dietgpu_tpu.floatcodec.pallas_float.split_words_pallas``
and ``split_words_pallas_f32``. For f16/bf16, (Lw/2,) u32 word pairs
become the packed exponent plane and the packed nonComp plane, (Lw/4,) u32
each; for f32, (Lw,) u32 words become the packed exponent plane (Lw/4,),
the packed low-u16 plane (Lw/2,) and the packed high-u8 plane (Lw/4,).
Both also give the exact exponent histogram of the first `length` words
and the folded XOR checksum of their bytes.

The kernels split each row of a (B, ...) batch at one static length, with
a histogram and a checksum per row, in one launch (counterpart of the
vmapped split kernels of ``float_compress_batched_pallas``); a single
tensor is a batch of one. The plain versions are per row, and their
batched forms loop over the rows.

The codec takes the kernel for a CUDA tensor and the plain version for a
CPU tensor.
"""

import torch

from .. import _build
from .. import constants as C
from ..ans import checksum, layout, stats
from . import split


def _check(pairs: torch.Tensor, length: int, float_type: int):
    if float_type not in split.HALF_TYPES:
        raise ValueError(f"split: float type {float_type} is not f16/bf16")
    if pairs.dtype != torch.int32 or pairs.dim() != 1:
        raise ValueError("split: pairs must be a 1-D int32 tensor of word pairs")
    Lw = 2 * pairs.shape[0]
    if Lw == 0 or Lw % C.DEFAULT_BLOCK_SIZE:
        raise ValueError(f"split: {Lw} words is not a positive multiple of 4096")
    if not 0 <= length <= Lw:
        raise ValueError(f"split: length {length} outside [0, {Lw}]")
    return Lw


def split_words_plain(pairs, length, float_type, with_checksum=False, nc_out=None):
    """Plain torch version of the split kernel.

    (Lw/2,) int32 word pairs -> (exp32, nc32, hist int32 (256,), checksum).
    Words at index >= length count as zero: they are zero in both planes
    and left out of the histogram. `checksum` (int32, 0-dim) is the folded
    XOR of the bytes of the first `length` words when `with_checksum`,
    else 0. `nc_out`, if given, receives the nonComp plane in place (the
    codec passes the container's plane region).
    """
    Lw = _check(pairs, length, float_type)
    words = pairs.view(torch.int16)
    valid = torch.arange(Lw, device=pairs.device) < length
    words = torch.where(valid, words, torch.zeros((), dtype=torch.int16, device=pairs.device))
    comp, (nc,) = split.split_words(words, float_type)
    hist = stats.histogram_u8(comp, length).to(torch.int32)
    cks = (
        checksum.checksum_u8(words.view(torch.uint8), 2 * length)
        if with_checksum
        else torch.zeros((), dtype=torch.int64, device=pairs.device)
    ).to(torch.int32)
    nc32 = layout.u8_to_u32le(nc)
    if nc_out is not None:
        nc_out.copy_(nc32)
        nc32 = nc_out
    return layout.u8_to_u32le(comp), nc32, hist, cks


def _check_f32(words: torch.Tensor, length: int):
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError("split f32: words must be a 1-D int32 tensor")
    Lw = words.shape[0]
    if Lw == 0 or Lw % C.DEFAULT_BLOCK_SIZE:
        raise ValueError(f"split f32: {Lw} words is not a positive multiple of 4096")
    if not 0 <= length <= Lw:
        raise ValueError(f"split f32: length {length} outside [0, {Lw}]")
    return Lw


def _into(out, plane32, keep32):
    """Copy the first keep32 u32 of a plane into `out`, if given."""
    if out is None:
        return plane32
    out[:keep32].copy_(plane32[:keep32])
    return out


def split_words_f32_plain(words, length, with_checksum=False, lo_out=None, hi_out=None):
    """Plain torch version of the f32 split kernel.

    (Lw,) int32 f32 words -> (exp32 (Lw/4,), lo32 (Lw/2,), hi32 (Lw/4,),
    hist int32 (256,), checksum int32 0-dim). Words at index >= length
    count as zero: they are zero in every plane and left out of the
    histogram. `checksum` is the folded XOR of the first 4 * length bytes
    when `with_checksum`, else 0. `lo_out` / `hi_out`, if given, receive
    only the archived part of their plane in place: round_up(length, 8)/2
    u32 of the low plane and round_up(length, 16)/4 u32 of the high plane
    (the codec passes the container's plane regions, which the next
    section follows at once).
    """
    Lw = _check_f32(words, length)
    dev = words.device
    valid = torch.arange(Lw, device=dev) < length
    words = torch.where(valid, words, torch.zeros((), dtype=torch.int32, device=dev))
    comp, (lo, hi) = split.split_words(words, C.FLOAT_TYPE_FLOAT32)
    hist = stats.histogram_u8(comp, length).to(torch.int32)
    cks = (
        checksum.checksum_u8(words.view(torch.uint8), 4 * length)
        if with_checksum
        else torch.zeros((), dtype=torch.int64, device=dev)
    ).to(torch.int32)
    lo32 = _into(lo_out, lo.view(torch.int32), C.round_up(length, 8) // 2)
    hi32 = _into(hi_out, layout.u8_to_u32le(hi), C.round_up(length, 16) // 4)
    return layout.u8_to_u32le(comp), lo32, hi32, hist, cks


# ---- B members of one static length, one launch ----


def _check_rows(out, what, B, width, align):
    """A (B, width) int32 destination whose rows may be strided (the
    members' containers), as the batched kernels write it."""
    if out.dtype != torch.int32 or out.shape != (B, width) or out.stride(1) != 1:
        raise ValueError(f"{what}: expected ({B}, {width}) int32 rows of contiguous words")
    if out.data_ptr() % align or (4 * out.stride(0)) % align:
        raise ValueError(f"{what}: rows must be {align}-byte aligned")


def split_words_batched_plain(pairs, length, float_type, with_checksum=False, nc_out=None):
    """Plain version of the batched split kernel: :func:`split_words_plain`
    of each row of `pairs` ((B, Lw/2) int32) at the one `length`. Returns
    (exp32 (B, Lw/4), nc32 (B, Lw/4), hist (B, 256) int32, checksums (B,)
    int32); `nc_out`, if given, is a (B, Lw/4) destination whose rows may be
    strided (the members' containers)."""
    if pairs.dim() != 2:
        raise ValueError("split: a batch is (B, Lw/2) int32 word pairs")
    rows = [
        split_words_plain(p, length, float_type, with_checksum,
                          None if nc_out is None else nc_out[m])
        for m, p in enumerate(pairs)
    ]
    exp32, nc32, hist, cks = (torch.stack(x) for x in zip(*rows))
    return exp32, nc32 if nc_out is None else nc_out, hist, cks


def split_words_batched_cuda(pairs, length, float_type, with_checksum=False, nc_out=None):
    """Launch ``csrc/split.cu``, one launch for all B rows; same contract as
    :func:`split_words_batched_plain`."""
    if pairs.dim() != 2:
        raise ValueError("split: a batch is (B, Lw/2) int32 word pairs")
    Lw = _check(pairs[0], length, float_type)
    _build.check_cuda_tensor(pairs, "split pairs", torch.int32)
    B = pairs.shape[0]
    dev = pairs.device
    exp32 = torch.empty((B, Lw // 4), dtype=torch.int32, device=dev)
    if nc_out is None:
        nc_out = torch.empty((B, Lw // 4), dtype=torch.int32, device=dev)
    _check_rows(nc_out, "split nc_out", B, Lw // 4, 8)
    hist = torch.zeros((B, C.NUM_SYMBOLS), dtype=torch.int32, device=dev)
    cks = torch.zeros(B, dtype=torch.int32, device=dev)
    _build.launch(
        "split", pairs.data_ptr(), B, Lw // 8, length,
        int(float_type == C.FLOAT_TYPE_BFLOAT16), exp32.data_ptr(), nc_out.data_ptr(),
        hist.data_ptr(), cks.data_ptr() if with_checksum else None,
        pairs.shape[1], Lw // 4, nc_out.stride(0),
    )
    return exp32, nc_out, hist, cks


def split_words_f32_batched_plain(words, length, with_checksum=False, lo_out=None,
                                  hi_out=None):
    """Plain version of the batched f32 split kernel:
    :func:`split_words_f32_plain` of each row of `words` ((B, Lw) int32) at
    the one `length`. Returns (exp32 (B, Lw/4), lo32 (B, Lw/2), hi32 (B,
    Lw/4), hist (B, 256) int32, checksums (B,) int32); `lo_out` / `hi_out`,
    if given, are destinations whose rows may be strided and receive only
    the archived part of each plane, as in the single form."""
    if words.dim() != 2:
        raise ValueError("split f32: a batch is (B, Lw) int32 words")
    rows = [
        split_words_f32_plain(w, length, with_checksum,
                              None if lo_out is None else lo_out[m],
                              None if hi_out is None else hi_out[m])
        for m, w in enumerate(words)
    ]
    exp32, lo32, hi32, hist, cks = (torch.stack(x) for x in zip(*rows))
    return (exp32, lo32 if lo_out is None else lo_out,
            hi32 if hi_out is None else hi_out, hist, cks)


def split_words_f32_batched_cuda(words, length, with_checksum=False, lo_out=None,
                                 hi_out=None):
    """Launch ``csrc/split_f32.cu``, one launch for all B rows; same
    contract as :func:`split_words_f32_batched_plain`. `lo_out` and `hi_out`
    must be both given (rows of one buffer, with one stride) or both left
    out."""
    if words.dim() != 2:
        raise ValueError("split f32: a batch is (B, Lw) int32 words")
    Lw = _check_f32(words[0], length)
    _build.check_cuda_tensor(words, "split f32 words", torch.int32)
    B = words.shape[0]
    dev = words.device
    exp32 = torch.empty((B, Lw // 4), dtype=torch.int32, device=dev)
    if (lo_out is None) != (hi_out is None):
        raise ValueError("split f32: give both plane destinations or neither")
    if lo_out is None:
        planes = torch.empty((B, 3 * Lw // 4), dtype=torch.int32, device=dev)
        lo_out, hi_out = planes[:, : Lw // 2], planes[:, Lw // 2 :]
        lo_quads, hi_quads = Lw // 4, Lw // 4
    else:
        lo_quads, hi_quads = C.round_up(length, 8) // 4, C.round_up(length, 16) // 4
    _check_rows(lo_out, "split f32 lo_out", B, Lw // 2, 8)
    _check_rows(hi_out, "split f32 hi_out", B, Lw // 4, 4)
    if lo_out.stride(0) != hi_out.stride(0):
        raise ValueError("split f32: lo_out and hi_out rows must share one stride")
    hist = torch.zeros((B, C.NUM_SYMBOLS), dtype=torch.int32, device=dev)
    cks = torch.zeros(B, dtype=torch.int32, device=dev)
    _build.launch(
        "split_f32", words.data_ptr(), B, Lw // 4, length, exp32.data_ptr(),
        lo_out.data_ptr(), lo_quads, hi_out.data_ptr(), hi_quads, hist.data_ptr(),
        cks.data_ptr() if with_checksum else None, words.shape[1], Lw // 4,
        lo_out.stride(0),
    )
    return exp32, lo_out, hi_out, hist, cks
