"""The float split kernels (``csrc/split.cu``, ``csrc/split_f32.cu``), the
join kernels (``csrc/join.cu``), and their plain versions.

Counterpart of ``dietgpu_tpu.floatcodec.pallas_float.split_words_pallas``
and ``split_words_pallas_f32``. For f16/bf16, (Lw/2,) u32 word pairs
become the packed exponent plane and the packed nonComp plane, (Lw/4,) u32
each; for f32, (Lw,) u32 words become the packed exponent plane (Lw/4,),
the packed low-u16 plane (Lw/2,) and the packed high-u8 plane (Lw/4,).
Both also give the exact exponent histogram of the first `length` words
and the folded XOR checksum of their bytes.

The kernels split each row of a (B, ...) batch at its own length, with a
histogram and a checksum per row, in one launch (counterpart of the
vmapped split kernels of ``float_compress_batched_pallas``); a single
tensor is a batch of one. The plain versions are per row, and their
batched forms loop over the rows.

The join kernels (``csrc/join.cu``) undo the split: packed planes back to
words, the counterpart of ``join_words_pallas`` and
``join_words_pallas_f32``. ``join_words_packed`` and
``join_words_packed_f32`` are the entry points.

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


# ---- B members, each of its own length, one launch ----


def _check_rows(out, what, B, width, align):
    """A (B, >= width) int32 destination whose rows may be strided (the
    members' containers), as the batched kernels write it."""
    if (out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != B
            or out.shape[1] < width or out.stride(1) != 1):
        raise ValueError(f"{what}: expected ({B}, >= {width}) int32 rows of contiguous words")
    if out.data_ptr() % align or (4 * out.stride(0)) % align:
        raise ValueError(f"{what}: rows must be {align}-byte aligned")


def split_words_batched_plain(pairs, length, float_type, with_checksum=False, nc_out=None,
                              lengths_t=None):
    """Plain version of the batched split kernel: :func:`split_words_plain`
    of each row of `pairs` ((B, Lw/2) int32) at its own length (`length`
    an int for every row, or B ints). Returns (exp32 (B, Lw/4), nc32 (B,
    Lw/4), hist (B, 256) int32, checksums (B,) int32); `nc_out`, if given,
    is a (B, Lw/4) destination whose rows may be strided (the members'
    containers). `lengths_t` is the kernel's device copy of the lengths;
    the plain version does not need it."""
    if pairs.dim() != 2:
        raise ValueError("split: a batch is (B, Lw/2) int32 word pairs")
    lengths = layout.member_lengths(length, pairs.shape[0], 2 * pairs.shape[1], "split")
    rows = [
        split_words_plain(p, n, float_type, with_checksum,
                          None if nc_out is None else nc_out[m])
        for m, (p, n) in enumerate(zip(pairs, lengths))
    ]
    exp32, nc32, hist, cks = (torch.stack(x) for x in zip(*rows))
    return exp32, nc32 if nc_out is None else nc_out, hist, cks


def split_words_batched_cuda(pairs, length, float_type, with_checksum=False, nc_out=None,
                             lengths_t=None):
    """Launch ``csrc/split.cu``, one launch for all B rows; same contract as
    :func:`split_words_batched_plain`. Ragged lengths go to the kernel as
    `lengths_t`, or as a device copy made here; the kernel reads no word
    past a member's length."""
    if pairs.dim() != 2:
        raise ValueError("split: a batch is (B, Lw/2) int32 word pairs")
    Lw = _check(pairs[0], 0, float_type)
    lengths = layout.member_lengths(length, pairs.shape[0], Lw, "split")
    _build.check_cuda_tensor(pairs, "split pairs", torch.int32)
    B = pairs.shape[0]
    dev = pairs.device
    n, n_t = layout.device_lengths(lengths, lengths_t, dev, "split lengths")
    exp32 = torch.empty((B, Lw // 4), dtype=torch.int32, device=dev)
    if nc_out is None:
        nc_out = torch.empty((B, Lw // 4), dtype=torch.int32, device=dev)
    _check_rows(nc_out, "split nc_out", B, Lw // 4, 8)
    nc_out = nc_out[:, : Lw // 4]
    hist = torch.zeros((B, C.NUM_SYMBOLS), dtype=torch.int32, device=dev)
    cks = torch.zeros(B, dtype=torch.int32, device=dev)
    _build.launch(
        "split", pairs.data_ptr(), B, Lw // 8, n, layout.data_ptr(n_t),
        sum((x + 7) // 8 for x in lengths),
        int(float_type == C.FLOAT_TYPE_BFLOAT16), exp32.data_ptr(), nc_out.data_ptr(),
        hist.data_ptr(), cks.data_ptr() if with_checksum else None,
        pairs.shape[1], Lw // 4, nc_out.stride(0),
    )
    return exp32, nc_out, hist, cks


def _planes_width(n):
    """u32 of the archived low plane, then of the archived high plane, of
    an f32 member of n words."""
    return C.round_up(n, 8) // 2, C.round_up(n, 16) // 4


def split_words_f32_batched_plain(words, length, with_checksum=False, planes_out=None,
                                  lengths_t=None):
    """Plain version of the batched f32 split kernel:
    :func:`split_words_f32_plain` of each row of `words` ((B, Lw) int32) at
    its own length (`length` an int for every row, or B ints).

    Returns (exp32 (B, Lw/4), lo32 (B, Lw/2), hi32 (B, Lw/4), hist (B,
    256) int32, checksums (B,) int32). `planes_out`, if given, is a (B,
    >= 3 Lw/4) int32 destination whose rows may be strided (the members'
    containers): row m receives member m's archived low plane, round_up(n,
    8)/2 u32, and right after it its archived high plane, round_up(n,
    16)/4 u32, as the container lays them out; lo32 and hi32 are then both
    `planes_out`. `lengths_t` is the kernel's device copy of the lengths.
    """
    if words.dim() != 2:
        raise ValueError("split f32: a batch is (B, Lw) int32 words")
    lengths = layout.member_lengths(length, words.shape[0], words.shape[1], "split f32")
    rows = []
    for m, (w, n) in enumerate(zip(words, lengths)):
        lo_out = hi_out = None
        if planes_out is not None:
            k, h = _planes_width(n)
            lo_out, hi_out = planes_out[m, :k], planes_out[m, k : k + h]
        rows.append(split_words_f32_plain(w, n, with_checksum, lo_out, hi_out))
    exp32, hist, cks = (torch.stack([r[i] for r in rows]) for i in (0, 3, 4))
    if planes_out is not None:
        return exp32, planes_out, planes_out, hist, cks
    lo32, hi32 = (torch.stack([r[i] for r in rows]) for i in (1, 2))
    return exp32, lo32, hi32, hist, cks


def split_words_f32_batched_cuda(words, length, with_checksum=False, planes_out=None,
                                 lengths_t=None):
    """Launch ``csrc/split_f32.cu``, one launch for all B rows; same
    contract as :func:`split_words_f32_batched_plain`. With `planes_out`
    the kernel runs in its container mode, each member's high plane at the
    offset its own length gives. Ragged lengths go to the kernel as
    `lengths_t`, or as a device copy made here; the kernel reads no word
    past a member's length."""
    if words.dim() != 2:
        raise ValueError("split f32: a batch is (B, Lw) int32 words")
    Lw = _check_f32(words[0], 0)
    lengths = layout.member_lengths(length, words.shape[0], Lw, "split f32")
    _build.check_cuda_tensor(words, "split f32 words", torch.int32)
    B = words.shape[0]
    dev = words.device
    n, n_t = layout.device_lengths(lengths, lengths_t, dev, "split lengths")
    exp32 = torch.empty((B, Lw // 4), dtype=torch.int32, device=dev)
    if planes_out is None:
        planes = torch.empty((B, 3 * Lw // 4), dtype=torch.int32, device=dev)
        lo32, hi32 = planes[:, : Lw // 2], planes[:, Lw // 2 :]
        lo_ptr, hi_ptr, stride = lo32.data_ptr(), hi32.data_ptr(), planes.stride(0)
    else:
        _check_rows(planes_out, "split f32 planes_out", B, 3 * Lw // 4, 8)
        lo32 = hi32 = planes_out
        lo_ptr, hi_ptr, stride = planes_out.data_ptr(), None, planes_out.stride(0)
    hist = torch.zeros((B, C.NUM_SYMBOLS), dtype=torch.int32, device=dev)
    cks = torch.zeros(B, dtype=torch.int32, device=dev)
    _build.launch(
        "split_f32", words.data_ptr(), B, Lw // 4, n, layout.data_ptr(n_t),
        sum((x + 127) // 128 for x in lengths), exp32.data_ptr(), lo_ptr, hi_ptr, hist.data_ptr(),
        cks.data_ptr() if with_checksum else None, words.shape[1], Lw // 4, stride,
    )
    return exp32, lo32, hi32, hist, cks


# ---- the standalone join: planes -> words ----


def _check_join(planes, widths, what):
    """Each plane a (B, n4 * width) int32 tensor of one B and n4, rows of
    contiguous words (the rows may be strided). Returns (B, n4)."""
    if any(p.dtype != torch.int32 or p.dim() != 2 or p.stride(1) != 1 for p in planes):
        raise ValueError(f"{what}: the planes must be (B, ...) int32 rows of contiguous words")
    B, n4 = planes[0].shape
    if any(p.shape != (B, n4 * w) for p, w in zip(planes, widths)):
        raise ValueError(f"{what}: the planes must hold {list(widths)} x n4 u32 per row")
    if B == 0:
        raise ValueError(f"{what}: empty batch")
    return B, n4


def join_words_plain(exp32, nc32, float_type):
    """Plain version of the join kernel (f16/bf16): (B, n4) int32 packed
    exponent bytes and (B, n4) int32 packed nonComp bytes -> (B, 2 n4)
    int32 word pairs, through :func:`split.join_words` on the unpacked
    planes."""
    if float_type not in split.HALF_TYPES:
        raise ValueError(f"join: float type {float_type} is not f16/bf16")
    B, n4 = _check_join((exp32, nc32), (1, 1), "join")
    comp, nc = (p.contiguous().view(torch.uint8) for p in (exp32, nc32))
    return split.join_words(comp, (nc,), float_type).view(torch.int32)


def join_words_cuda(exp32, nc32, float_type):
    """Launch the f16/bf16 configuration of ``csrc/join.cu``, one launch
    for all B rows; same contract as :func:`join_words_plain`."""
    if float_type not in split.HALF_TYPES:
        raise ValueError(f"join: float type {float_type} is not f16/bf16")
    B, n4 = _check_join((exp32, nc32), (1, 1), "join")
    for p, what in ((exp32, "join exp32"), (nc32, "join nc32")):
        if not p.is_cuda:
            raise ValueError(f"{what}: expected a CUDA tensor")
    out = torch.empty((B, 2 * n4), dtype=torch.int32, device=exp32.device)
    if n4:
        _build.launch(
            "join", exp32.data_ptr(), nc32.data_ptr(), B, n4,
            int(float_type == C.FLOAT_TYPE_BFLOAT16), out.data_ptr(), exp32.stride(0),
            nc32.stride(0), out.stride(0),
        )
    return out


def join_words_f32_plain(exp32, lo32, hi32):
    """Plain version of the f32 join kernel: (B, n4) int32 packed exponent
    bytes, (B, 2 n4) int32 packed low u16 and (B, n4) int32 packed high
    bytes -> (B, 4 n4) int32 words, through :func:`split.join_words`."""
    _check_join((exp32, lo32, hi32), (1, 2, 1), "join f32")
    comp, hi = (p.contiguous().view(torch.uint8) for p in (exp32, hi32))
    lo = lo32.contiguous().view(torch.int16)
    return split.join_words(comp, (lo, hi), C.FLOAT_TYPE_FLOAT32)


def join_words_f32_cuda(exp32, lo32, hi32):
    """Launch the f32 configuration of ``csrc/join.cu``, one launch for all
    B rows; same contract as :func:`join_words_f32_plain`."""
    B, n4 = _check_join((exp32, lo32, hi32), (1, 2, 1), "join f32")
    for p, what in ((exp32, "join exp32"), (lo32, "join lo32"), (hi32, "join hi32")):
        if not p.is_cuda:
            raise ValueError(f"{what}: expected a CUDA tensor")
    out = torch.empty((B, 4 * n4), dtype=torch.int32, device=exp32.device)
    if n4:
        _build.launch(
            "join_f32", exp32.data_ptr(), lo32.data_ptr(), hi32.data_ptr(), B, n4,
            out.data_ptr(), exp32.stride(0), lo32.stride(0), hi32.stride(0), out.stride(0),
        )
    return out


def _as_batch(*planes):
    """1-D planes -> a batch of one (and True), 2-D planes as they are."""
    one = planes[0].dim() == 1
    return [p[None] if one else p for p in planes], one


def join_words_packed(exp32, nc32, float_type):
    """Packed exponent and nonComp planes -> f16/bf16 word pairs.

    Counterpart of
    ``dietgpu_tpu.floatcodec.pallas_float.join_words_pallas``: (n4,) int32
    planes (4 words' bytes per u32, any n4) -> (2 n4,) int32 word pairs;
    (B, n4) planes give (B, 2 n4). Planes on the card go through the join
    kernel, planes on the CPU through its plain version.
    """
    (e, c), one = _as_batch(exp32, nc32)
    fn = join_words_cuda if e.is_cuda else join_words_plain
    out = fn(e, c, float_type)
    return out[0] if one else out


def join_words_packed_f32(exp32, lo32, hi32):
    """Packed exponent, low and high planes -> f32 words.

    Counterpart of
    ``dietgpu_tpu.floatcodec.pallas_float.join_words_pallas_f32``: (n4,)
    exponent and high planes and a (2 n4,) low plane, int32 -> (4 n4,)
    int32 words; (B, ...) planes give (B, 4 n4). Planes on the card go
    through the join kernel, planes on the CPU through its plain version.
    """
    (e, lo, hi), one = _as_batch(exp32, lo32, hi32)
    fn = join_words_f32_cuda if e.is_cuda else join_words_f32_plain
    out = fn(e, lo, hi)
    return out[0] if one else out
