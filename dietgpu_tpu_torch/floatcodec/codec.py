"""Float codec (f16/bf16/f32): compress and decompress, on the card or the
CPU.

Counterpart of ``dietgpu_tpu.floatcodec.pallas_codec`` and
``dietgpu_tpu.floatcodec.codec``. The container layouts are the
reference's (GpuFloatCompress.cuh:420-427, GpuFloatUtils.cuh:181-203):

  f16/bf16: [16 B float header | nonComp plane, round_up(n, 16) B |
             ANS archive]
  f32:      [16 B float header | low-u16 plane, 2 round_up(n, 8) B |
             high-u8 plane, round_up(n, 16) B | ANS archive]

held as an int32 buffer whose little-endian bytes are the container.

Compress runs the split kernel (which writes the raw planes straight into
the container), the tables kernel (the exponent histogram's weights and
encode table), then encodes the exponent plane into the container right
after the planes. Decompress is
one fused decode+join kernel on the container. float_compress_batched and
float_decompress_batched do the same for B members of ragged lengths, rows
of one buffer, with one launch of each kernel; a single tensor is a batch
of one. Tensors on the card go through the kernels, tensors on the CPU
through their plain versions; nothing else selects the path.
float_compress_padded_plain is the plain pipeline on any device, the
reference for the kernel path.
"""

import numpy as np
import torch

from .. import constants as C
from ..ans import checksum, cuda_decode, cuda_encode, layout
from ..ans import encode as ans_encode
from ..profiling import annotate, host_read
from . import cuda_float


# the fused decode+join's stage range, by whether the type is f32
_DECODE_STAGE = ("float.fused_decode_join", "float.fused_decode_join_f32")


def float_archive_buffer_bytes(float_type: int, padded_words: int) -> int:
    """Static container size (bytes) for inputs padded to padded_words."""
    return (
        C.FLOAT_HEADER_BYTES
        + C.float_noncomp_bytes(float_type, padded_words)
        + ans_encode.archive_buffer_bytes(padded_words)
    )


def _as_words(words: torch.Tensor, float_type: int) -> torch.Tensor:
    """f16/bf16: (Lw/2,) int32 word pairs, or (Lw,) int16/uint16 words ->
    int32 pairs. f32: (Lw,) int32 words, or float32 values -> int32 words.
    A view, no copy."""
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError("float codec: words must be a contiguous 1-D tensor")
    if words.dtype == torch.int32:
        return words
    if float_type == C.FLOAT_TYPE_FLOAT32:
        if words.dtype == torch.float32:
            return words.view(torch.int32)
    elif words.dtype in (torch.int16, torch.uint16):
        if words.shape[0] % 2:
            raise ValueError("float codec: odd number of 16-bit words")
        return words.view(torch.int16).view(torch.int32)
    raise ValueError(f"float codec: unsupported word dtype {words.dtype}")


def float_compress_padded(
    words: torch.Tensor,
    length: int,
    float_type: int,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    use_checksum: bool = False,
):
    """Compress the first `length` float words of `words`.

    Args:
      words: f16/bf16: (Lw/2,) int32 word pairs (the layout bench.py
        passes) or (Lw,) int16/uint16 words; f32: (Lw,) int32 words or
        float32 values. Lw is a positive multiple of 4096.
      length: word count, 0 <= length <= Lw.

    Returns (archive (F/4,) int32, size 0-dim int64 bytes on the device),
    F = float_archive_buffer_bytes(float_type, Lw). archive bytes [0, size)
    equal the JAX package's archive for the same input; bytes past size are
    unspecified. Words on the card go through the kernels, words on the CPU
    through their plain versions. It is :func:`float_compress_batched` on a
    batch of one.
    """
    return _compress(
        words, length, float_type, prob_bits, use_checksum, plain=not words.is_cuda
    )


def float_compress_padded_plain(
    words: torch.Tensor,
    length: int,
    float_type: int,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    use_checksum: bool = False,
):
    """:func:`float_compress_padded` through every kernel's plain version,
    on the device of `words`: the reference the chip check holds the
    kernel path against on the card."""
    return _compress(words, length, float_type, prob_bits, use_checksum, plain=True)


def _compress(words, length, float_type, prob_bits, use_checksum, plain):
    words = _as_words(words, float_type)
    arcs, sizes = _compress_batched(words[None], int(length), float_type, prob_bits,
                                    use_checksum, plain, batched=False)
    return arcs[0], sizes[0]


def float_decompress_padded(
    archive: torch.Tensor,
    float_type: int,
    out_max_words: int,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    verify_checksum: bool = False,
    static_length: int | None = None,
):
    """Decompress a float container ((A,) int32 u32 words).

    `static_length` is a contract, as in the JAX package: when the header's
    word count differs from min(static_length, out_max_words), `success`
    fails.

    Returns dict: out32 ((out_max_words/2,) int32 word pairs for f16/bf16,
    (out_max_words,) int32 words for f32, zero past the word count), size
    (int64, header word count), success (bool),
    checksum_ok (bool; False only on a verified mismatch), all on the
    archive's device.
    """
    with annotate(_DECODE_STAGE[float_type == C.FLOAT_TYPE_FLOAT32], archive.is_cuda):
        out32, success, size, digest = cuda_decode.decode_float(
            archive, float_type, out_max_words, prob_bits, static_length,
            with_digest=verify_checksum,
        )
    checksum_ok = torch.ones((), dtype=torch.bool, device=archive.device)
    if verify_checksum:
        checksum_ok = checksum.verified(archive[2:4], digest)
    return {
        "out32": out32,
        "size": size,
        "success": success,
        "checksum_ok": checksum_ok,
    }


# ---- batched: B members, ragged lengths, one launch per kernel ----


def float_compress_batched(
    words: torch.Tensor,
    length,
    float_type: int,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    use_checksum: bool = False,
):
    """Compress B float tensors, each with its own probability table, with
    one launch of each kernel whatever B is.

    Counterpart of
    ``dietgpu_tpu.floatcodec.pallas_codec.float_compress_batched_pallas``
    (one static length), and of the JAX API's vmapped single-tensor
    compress (``api._batch_float_encode``) for ragged members. `words` is
    (B, Lw/2) int32 word pairs or (B, Lw) int16/uint16 words for f16/bf16,
    (B, Lw) int32 words or float32 values for f32; Lw a positive multiple
    of 4096. `length` is the members' word counts: an int for every member,
    or B ints, each in [0, Lw].

    Returns (archives (B, F/4) int32, sizes (B,) int64 bytes), F =
    float_archive_buffer_bytes(float_type, Lw): row m is member m's
    container, laid out as :func:`float_compress_padded` lays out one, and
    its bytes [0, sizes[m]) equal the JAX package's archive for member m.
    Each member's ANS archive starts at its own 4 + plane32(n_m) u32. The
    split kernel writes the raw planes straight into the rows, and the
    batched assembly the payloads; the torch ops between the kernels are
    the same few whatever B is.
    """
    return _compress_batched(
        words, length, float_type, prob_bits, use_checksum, plain=not words.is_cuda,
        batched=True,
    )


def float_compress_batched_plain(
    words: torch.Tensor,
    length,
    float_type: int,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    use_checksum: bool = False,
):
    """:func:`float_compress_batched` through every kernel's plain version,
    on the device of `words`: the reference the chip check holds the
    batched kernels against on the card."""
    return _compress_batched(words, length, float_type, prob_bits, use_checksum, plain=True,
                             batched=True)


def _archive_base(lengths, float_type):
    """Each member's ANS archive offset in its container (u32, numpy): the
    archive follows the member's own raw planes."""
    lens = np.asarray(lengths, np.int64)
    base = 4 + (lens + 15) // 16 * 4
    if float_type == C.FLOAT_TYPE_FLOAT32:
        base += (lens + 7) // 8 * 4
    return base


def _header(n, float_type, use_checksum):
    """The float header's four u32 words for n words (the checksum, word
    3, is 0 until the split gives it)."""
    return ((C.FLOAT_MAGIC << 16) | C.FLOAT_VERSION, n,
            (float_type & 0xF) | (int(use_checksum) << 4), 0)


def ragged_geometry(lengths, float_type, use_checksum, dev):
    """What a ragged batch of `lengths` (B ints) takes from the host, as a
    read-only (5, B) int64 :func:`layout.device_constant` on `dev`: each
    member's four header words (the second its length) and its archive
    offset."""
    lens = np.asarray(lengths, np.int64)

    def make():
        return np.stack(np.broadcast_arrays(*_header(lens, float_type, use_checksum),
                                            _archive_base(lens, float_type)))

    key = ("float", layout.ints_key(lens), float_type, bool(use_checksum))
    return layout.device_constant(key, dev, make)


def _compress_batched(words, length, float_type, prob_bits, use_checksum, plain, batched):
    """`batched` names the ANS stages' ranges: the ``_batched`` forms for
    the batched entry points, as the JAX package names them."""
    if float_type not in cuda_decode.FLOAT_TYPES:
        raise ValueError(f"float type {float_type} is not f16/bf16/f32")
    if prob_bits not in C.SUPPORTED_PROB_BITS:
        raise ValueError(f"prob_bits {prob_bits} not in {C.SUPPORTED_PROB_BITS}")
    if words.dim() != 2 or words.shape[0] == 0 or not words.is_contiguous():
        raise ValueError("float codec: a batch is a contiguous (B, ...) tensor of words, B > 0")
    B = words.shape[0]
    words = _as_words(words.view(-1), float_type).view(B, -1)
    dev = words.device
    f32 = float_type == C.FLOAT_TYPE_FLOAT32
    Lw = words.shape[1] if f32 else 2 * words.shape[1]
    lengths = layout.member_lengths(length, B, Lw, "float compress")
    base = _archive_base(lengths, float_type)
    arcs = torch.empty(
        (B, float_archive_buffer_bytes(float_type, Lw) // 4), dtype=torch.int32, device=dev
    )
    if all(n == lengths[0] for n in lengths):
        n, lengths_t, base32 = lengths[0], None, int(base[0])
        base_t = base32
        for c, v in enumerate(_header(n, float_type, use_checksum)):  # a fill a word
            arcs[:, c] = layout.as_i32(v)
    else:
        host = ragged_geometry(lengths, float_type, use_checksum, dev)
        arcs[:, :4] = layout.to_i32(host[:4].T)
        n = lengths_t = host[1]
        base32, base_t = base.tolist(), host[4]
    cuda = words.is_cuda
    with annotate("float.split", cuda):
        if f32:
            split_fn = (
                cuda_float.split_words_f32_batched_plain if plain
                else cuda_float.split_words_f32_batched_cuda
            )
            exp32, _, _, hist, cks = split_fn(
                words, lengths, use_checksum, planes_out=arcs[:, 4:], lengths_t=lengths_t,
            )
        else:
            split_fn = (
                cuda_float.split_words_batched_plain if plain
                else cuda_float.split_words_batched_cuda
            )
            exp32, _, hist, cks = split_fn(
                words, lengths, float_type, use_checksum, nc_out=arcs[:, 4 : 4 + Lw // 4],
                lengths_t=lengths_t,
            )
    with annotate("float.stats", cuda):
        pdfs, tables = cuda_encode.quantize(hist, n, prob_bits, plain)
    if use_checksum:
        arcs[:, 3] = cks

    with annotate("float.ans_encode", cuda):
        ans_sizes = cuda_encode.ans_encode_batched_into(
            arcs, base32, exp32, lengths, prob_bits, pdfs, plain=plain, lengths_t=lengths_t,
            batched=batched, tables=tables,
        )
    return arcs, ans_sizes + 4 * base_t


def float_decompress_batched(
    archives: torch.Tensor,
    float_type: int,
    out_max_words: int,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    verify_checksum: bool = False,
    static_length: int | None = None,
):
    """Decompress B float containers, rows of `archives` ((B, F/4) int32),
    with one launch of the decode kernel.

    Counterpart of
    ``dietgpu_tpu.floatcodec.pallas_codec.float_decompress_batched_pallas``.
    The row length is the member stride, and nothing past a member's row is
    read, so a lying header fails only its own member. Members may hold
    ragged word counts, each read from its own header on the device;
    `static_length` is the same contract as in
    :func:`float_decompress_padded`, for every member.

    Returns the dict of :func:`float_decompress_padded` with a leading (B,)
    dim: out32 ((B, out_max_words/2) int32 word pairs for f16/bf16, (B,
    out_max_words) int32 words for f32), size, success, checksum_ok.
    """
    with annotate(_DECODE_STAGE[float_type == C.FLOAT_TYPE_FLOAT32], archives.is_cuda):
        out32, success, size, digest = cuda_decode.decode_float_batched(
            archives, float_type, out_max_words, prob_bits, static_length,
            with_digest=verify_checksum,
            static_nb=cuda_decode.static_block_count(static_length, out_max_words),
        )
    checksum_ok = torch.ones(archives.shape[0], dtype=torch.bool, device=archives.device)
    if verify_checksum:
        checksum_ok = checksum.verified(archives[:, 2:4], digest)
    return {
        "out32": out32,
        "size": size,
        "success": success,
        "checksum_ok": checksum_ok,
    }


def float_decompress_members(
    archives,
    a32: int,
    float_type: int,
    out_max_words: int,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    outs=None,
):
    """:func:`float_decompress_batched` of B containers read where they lie
    (``cuda_decode.decode_members``: each archive as the row of `a32` u32
    a zero-filled buffer would hold), with no checksum and one launch of
    the decode kernel. `outs` None returns the (B, ...) out32 of
    :func:`float_decompress_batched`; B contiguous tensors are written in
    place instead, each up to its own word count, and left as they were
    where their member fails. Returns dict: out32 (or None) and status, the
    (B, 3) int32 words that ``cuda_decode.status_fields`` reads."""
    with annotate(_DECODE_STAGE[float_type == C.FLOAT_TYPE_FLOAT32], archives[0].is_cuda):
        out32, status = cuda_decode.decode_members(
            archives, a32, out_max_words, prob_bits, float_type, outs)
    return {"out32": out32, "status": status}


_TYPES = {
    torch.float16: C.FLOAT_TYPE_FLOAT16,
    torch.bfloat16: C.FLOAT_TYPE_BFLOAT16,
    torch.float32: C.FLOAT_TYPE_FLOAT32,
}


def _device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def float_compress(
    x: torch.Tensor, prob_bits: int = C.DEFAULT_PROB_BITS,
    use_checksum: bool = False, device=None,
) -> torch.Tensor:
    """Compress an f16/bf16/f32 tensor; returns the archive as (size/4,)
    int32.

    `device=None` means the card (and raises if there is none).
    """
    if x.dtype not in _TYPES:
        raise ValueError(f"float_compress: dtype {x.dtype} is not f16/bf16/f32")
    dev = _device(device)
    n = x.numel()
    Lw = C.round_up(max(n, 1), C.DEFAULT_BLOCK_SIZE)
    wdtype = torch.int32 if x.dtype == torch.float32 else torch.int16
    words = torch.zeros(Lw, dtype=wdtype, device=dev)
    words[:n] = x.detach().reshape(-1).view(wdtype).to(dev)
    arc32, size = float_compress_padded(
        words, n, _TYPES[x.dtype], prob_bits, use_checksum
    )
    size = int(host_read(size))
    if size & C.SIZE_OVERFLOW_BIT:
        raise OverflowError("float_compress: a block overflowed its payload bound")
    return arc32[: size // 4].clone()


def float_decompress(
    archive: torch.Tensor, prob_bits: int = C.DEFAULT_PROB_BITS, device=None
) -> torch.Tensor:
    """Decompress an archive from float_compress into a 1-D f16/bf16/f32
    tensor.

    `device=None` means the card (and raises if there is none). Raises
    ValueError when the archive does not decode or fails its checksum.
    """
    dev = _device(device)
    arc32 = archive.to(dev).contiguous()
    if arc32.dtype != torch.int32 or arc32.dim() != 1 or arc32.shape[0] < 4:
        raise ValueError("float_decompress: expected a 1-D int32 archive")
    h = host_read(layout.to_u32(arc32[:4])).tolist()
    types = {v: k for k, v in _TYPES.items()}
    if h[2] & 0xF not in types:
        raise ValueError("float_decompress: not a float archive")
    n = h[1]
    Lw = C.round_up(max(n, 1), C.DEFAULT_BLOCK_SIZE)
    res = float_decompress_padded(
        arc32, h[2] & 0xF, Lw, prob_bits, verify_checksum=True, static_length=n
    )
    if not bool(host_read(res["success"] & res["checksum_ok"])):
        raise ValueError("float_decompress: archive failed to decode")
    return res["out32"].view(types[h[2] & 0xF])[:n]
