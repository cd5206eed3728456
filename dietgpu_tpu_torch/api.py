"""The ten-op batch API, on the card or the CPU.

Counterpart of ``dietgpu_tpu.api``: the reference's ``torch.ops.dietgpu.*``
ops (DietGpu.cpp:915-972) as a functional surface that returns new tensors
and never writes its inputs (``torch_api`` has the in-place contract):

  torch.ops.dietgpu.*                 dietgpu_tpu_torch.api.*
  ---------------------------------   ---------------------------------------
  max_any_compressed_size             max_any_compressed_size
  max_float_compressed_size           max_float_compressed_size
  max_any_compressed_output_size      max_any_compressed_output_size
  max_float_compressed_output_size    max_float_compressed_output_size
  compress_data                       compress_data -> (comp, sizes, tempMem)
  compress_data_split_size            compress_data_split_size
  compress_data_simple                compress_data_simple
  decompress_data                     decompress_data -> (outs, status, sizes, tempMem)
  decompress_data_split_size          decompress_data_split_size
  decompress_data_simple              decompress_data_simple

plus the stride forms and the header queries of the JAX package, and
``decompress_members``, ``decompress_data`` with each member's verdict
left on the device (for the checkpoint, which names a failing entry).

A batch is B tensors of any lengths, all on one device. A compress
gathers them into the rows of one padded buffer (one copy per member, or
one stack when the lengths are equal) and goes through the batched codec
with one launch of each kernel: ``float_compress_batched`` or
``ans_encode_batched``. A decompress reads each archive where it lies
(``float_decompress_members`` / ``ans_decode_members``) where the
archives allow it (``cuda_decode.takes_members``) and no checksum is verified,
else from such a buffer (``float_decompress_batched`` /
``ans_decode_batched``), one launch of the decode kernel either way.
Tensors on the card go through the kernels, tensors on the CPU through
their plain versions.

Each public compress entry point runs inside the span ``front.compress``
and each decompress one inside ``front.decompress`` (``profiling``); an
entry that another calls is a child of the caller's span. Every host read
goes through ``profiling.host_read``, which counts it.

Results equal the JAX API's: row b's archive ``comp[b, :sizes[b]]`` byte
for byte, sizes, status, temp_mem and decoded tensors, and the same
exceptions. Only the padded width of ``comp`` differs: compress pads to a
multiple of 4096 words or bytes, where the JAX package rounds the block
count up to a power of two for its compile cache. Decompress reads and
decodes at the JAX package's width (:func:`_bucket_words`), since what a
too-small output or a lying header decodes to depends on it.
"""

from typing import Sequence

import torch

from . import constants as C
from . import headers
from .ans import cuda_decode, cuda_encode, layout
from .ans import decode as ans_decode
from .ans import encode as ans_encode
from .floatcodec import codec
from .profiling import COPY_BYTES, DIRECT_MEMBERS, count, entry, host_read

_FLOAT_TYPE = {
    torch.float16: C.FLOAT_TYPE_FLOAT16,
    torch.bfloat16: C.FLOAT_TYPE_BFLOAT16,
    torch.float32: C.FLOAT_TYPE_FLOAT32,
}
_DTYPE = {v: k for k, v in _FLOAT_TYPE.items()}
_WORD = {2: torch.int16, 4: torch.int32}


def float_type_of(dtype) -> int:
    if dtype not in _FLOAT_TYPE:
        raise ValueError(f"unsupported float dtype {str(dtype).removeprefix('torch.')}")
    return _FLOAT_TYPE[dtype]


def _byte_length(t: torch.Tensor) -> int:
    return t.nbytes


def _as_words(t: torch.Tensor) -> torch.Tensor:
    """The raw int16/int32 words of a float tensor, flat."""
    return t.reshape(-1).view(_WORD[t.element_size()])


def _device(ts: Sequence[torch.Tensor]) -> torch.device:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"all batch members must be on one device, got {sorted(map(str, devs))}")
    return devs.pop()


def _view_as(t: torch.Tensor, dtype) -> torch.Tensor:
    """The bits of `t` as `dtype` (bf16 through int16)."""
    if dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.view(dtype)


# the same-width integer dtypes that carry the bits of those a fused copy
# must not take as they are: on the card it copies f16/bf16 through float,
# which rewrites every NaN as 0x7FFF where a lossless codec keeps each
# payload, and torch has few kernels for unsigned, bool and float8 tensors
_BITS = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
         torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64,
         torch.bool: torch.uint8, torch.float8_e4m3fn: torch.uint8,
         torch.float8_e5m2: torch.uint8, torch.float8_e4m3fnuz: torch.uint8,
         torch.float8_e5m2fnuz: torch.uint8}


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """`t` as its same-width integer dtype where torch ops would not carry
    its bits as they are (f16/bf16, unsigned, bool, float8); else `t`
    itself."""
    return t.view(_BITS[t.dtype]) if t.dtype in _BITS else t


def copy_bits_(dsts: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor]) -> None:
    """dsts[m] = srcs[m] bit for bit, in one fused copy, through
    :func:`as_bits` (a view costs the host about a microsecond, so only
    the members that need one are viewed: pass sources already in their
    integer dtype where the caller has them so). Counts the bytes written
    as ``copy_bytes``."""
    if dsts:
        count(COPY_BYTES, sum(d.numel() * d.element_size() for d in dsts))
        torch._foreach_copy_([as_bits(d) for d in dsts], [as_bits(s) for s in srcs])


def _row_views(buf: torch.Tensor, lengths) -> list:
    """Views of the first lengths[m] elements of row m of a contiguous (B,
    W) buffer, made by one split."""
    W = buf.shape[1]
    return list(torch.split(buf.view(-1), [x for n in lengths for x in (n, W - n)])[0::2])


def _rows(rows: Sequence[torch.Tensor], width: int) -> torch.Tensor:
    """Flat tensors of one dtype -> (B, width), row m holding rows[m]
    (truncated to width) and zeros after it: one stack when every row
    fills the width, else one fused copy of every row into a zeroed
    buffer. Counts the bytes the stack or the zero fill writes as
    ``copy_bytes``, and :func:`copy_bits_` those of the copy."""
    count(COPY_BYTES, len(rows) * width * rows[0].element_size())
    if all(r.numel() == width for r in rows):
        return torch.stack(list(rows))
    rows = [r if r.numel() <= width else r[:width] for r in rows]
    out = torch.zeros((len(rows), width), dtype=rows[0].dtype, device=rows[0].device)
    copy_bits_(_row_views(out, [r.numel() for r in rows]), rows)
    return out


def _padded_width(n: int) -> int:
    return C.round_up(max(n, 1), C.DEFAULT_BLOCK_SIZE)


def _bucket_words(max_words: int) -> int:
    """A power-of-two number of 4096-word blocks, at least `max_words`: the
    JAX API's decode width (``dietgpu_tpu.api._bucket_words``)."""
    blocks = max(1, C.div_up(max_words, C.DEFAULT_BLOCK_SIZE))
    p = 1
    while p < blocks:
        p *= 2
    return p * C.DEFAULT_BLOCK_SIZE


# ---------------------------------------------------------------------------
# size queries (host)
# ---------------------------------------------------------------------------


def max_any_compressed_size(nbytes: int) -> int:
    """Reference-parity archive size bound (GpuANSEncode.cu:13-25)."""
    return C.max_compressed_size(nbytes)


def max_float_compressed_size(dtype, size: int) -> int:
    return C.max_float_compressed_size(float_type_of(dtype), size)


def max_any_compressed_output_size(ts: Sequence[torch.Tensor]) -> tuple[int, int]:
    return len(ts), max(max_any_compressed_size(_byte_length(t)) for t in ts)


def max_float_compressed_output_size(ts: Sequence[torch.Tensor]) -> tuple[int, int]:
    return len(ts), max(max_float_compressed_size(t.dtype, t.numel()) for t in ts)


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------


@entry("front.compress")
def compress_data(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Compress a batch of tensors.

    Returns (comp uint8 (B, bufsize), sizes int32 (B,), temp_mem_used int),
    comp and sizes on the members' device. Row b's archive occupies
    comp[b, :sizes[b]]. A negative sizes[b] (C.SIZE_OVERFLOW_BIT set) marks
    a per-block payload overflow, as in the JAX package; that row's archive
    is invalid.
    """
    if len(ts_in) == 0:
        raise ValueError("empty batch")
    _device(ts_in)
    B = len(ts_in)
    if compress_as_float:
        ft = float_type_of(ts_in[0].dtype)
        for t in ts_in:
            if float_type_of(t.dtype) != ft:
                raise ValueError("all batch members must share a dtype")
        words = [_as_words(t) for t in ts_in]
        lens = [w.numel() for w in words]
        padded = _rows(words, _padded_width(max(lens)))
        arcs, sizes = codec.float_compress_batched(padded, lens, ft, prob_bits, checksum)
        max_size = max(lens) * C.float_word_size(ft)
    else:
        datas = [layout.as_bytes(t) for t in ts_in]
        lens = [d.numel() for d in datas]
        padded = _rows(datas, _padded_width(max(lens)))
        arcs, sizes = cuda_encode.ans_encode_batched(padded, lens, None, prob_bits, checksum)
        max_size = max(lens)
    temp_mem = ans_encode.encode_scratch_bytes(max_size, B)
    return arcs.view(torch.uint8), layout.to_i32(sizes), temp_mem


@entry("front.compress")
def compress_data_simple(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Convenience tier: returns a list of exactly-sized uint8 archives
    (one device-to-host read of the sizes, like the reference's _simple
    ops). Raises OverflowError if any member hit the per-block payload
    bound."""
    comp, sizes, _ = compress_data(compress_as_float, ts_in, checksum, prob_bits)
    sizes_h = host_read(sizes).tolist()
    bad = [i for i, s in enumerate(sizes_h) if s < 0]
    if bad:
        raise OverflowError(f"compressed block payload overflow in batch elements {bad}")
    return [comp[i, :s].clone() for i, s in enumerate(sizes_h)]


def _split_pieces(flat: torch.Tensor, split_sizes, what: str):
    """Consecutive views of `flat`, checked as the reference checks a split
    (GpuANSEncode.cu:131-148): the sizes sum to the whole and every
    interior boundary is 4-byte aligned."""
    split_sizes = [int(s) for s in split_sizes]
    if sum(split_sizes) != flat.numel():
        raise ValueError(f"split sizes must sum to the {what} size")
    word = flat.element_size()
    off = 0
    for s in split_sizes[:-1]:
        off += s * word
        if off % C.ANS_REQUIRED_ALIGNMENT != 0:
            raise ValueError(
                "interior split boundaries must be 4-byte aligned "
                f"(offset {off})"
            )
    pieces = []
    off = 0
    for s in split_sizes:
        pieces.append(flat[off : off + s])
        off += s
    return pieces


@entry("front.compress")
def compress_data_split_size(
    compress_as_float: bool,
    t_in: torch.Tensor,
    split_sizes: Sequence[int],
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Compress consecutive splits of one flat tensor as a batch. Interior
    splits must keep 4-byte alignment of their start offsets."""
    pieces = _split_pieces(t_in.reshape(-1), split_sizes, "input")
    return compress_data(compress_as_float, pieces, checksum, prob_bits)


@entry("front.compress")
def compress_data_stride(
    compress_as_float: bool,
    t_in: torch.Tensor,
    sizes: Sequence[int] | None = None,
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Compress the rows of a 2-D (batch, stride) tensor as a batch
    (BatchProviderStride, ans/BatchProvider.cuh:39-69). Row b's payload is
    t_in[b, :sizes[b]] (elements; defaults to the full stride).

    Returns (comp, sizes_bytes, temp_mem) as compress_data.
    """
    if t_in.dim() != 2:
        raise ValueError("stride form expects a 2-D (batch, stride) array")
    B, stride = t_in.shape
    sizes = [stride] * B if sizes is None else [int(s) for s in sizes]
    if len(sizes) != B or any(s < 0 or s > stride for s in sizes):
        raise ValueError("per-row sizes must be within [0, stride]")
    rows = [t_in[b, : sizes[b]] for b in range(B)]
    return compress_data(compress_as_float, rows, checksum, prob_bits)


# ---------------------------------------------------------------------------
# decompress
# ---------------------------------------------------------------------------


@entry("front.decompress")
def decompress_data(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    ts_out: Sequence[torch.Tensor],
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Decompress archives into new tensors shaped and typed like ts_out
    (whose contents are not read).

    Returns (outs, status uint8 (B,), sizes int32 (B,), temp_mem_used), on
    the archives' device. As in the reference, status[b] is 0 and sizes[b]
    holds the required byte count when ts_out[b] is too small
    (GpuANSCodec.h:213-223); a checksum mismatch raises ValueError
    (DietGpu.cpp:617-620). The batch decodes at the JAX API's width, the
    largest output rounded up to a power-of-two number of 4096-word blocks
    (:func:`_bucket_words`); each archive is read up to that width's
    archive buffer, and nothing past it.

    The block geometry always comes from each archive's header, as on the
    JAX API's XLA route. The JAX API's Pallas one-grid route (its
    `_static_sizes`, set by the `_simple` tier for B > 1 without a
    checksum) takes it from the sizes instead and fails a member whose
    header's block count differs; the port has no such route.
    """
    return _decompress_checked(compress_as_float, ts_in, ts_out, checksum, prob_bits)


def _decompress_checked(compress_as_float, ts_in, ts_out, checksum, prob_bits, bits=False):
    """:func:`decompress_data`; `bits` as in :func:`decompress_members`."""
    outs, ok, sizes_bytes, checksum_ok = decompress_members(
        compress_as_float, ts_in, ts_out, checksum, prob_bits, bits=bits)
    if checksum and not bool(host_read(checksum_ok.all())):
        bad = host_read(torch.nonzero(~checksum_ok).flatten()).tolist()
        raise ValueError(f"checksum mismatch in batch elements {bad}")
    caps = _out_caps(compress_as_float, ts_out)
    temp_mem = ans_decode.decode_scratch_bytes(max(caps), len(ts_in))
    return outs, ok.to(torch.uint8), sizes_bytes, temp_mem


def _out_caps(compress_as_float: bool, ts_out) -> list:
    """Each output's capacity: words for float archives, else bytes."""
    return [t.numel() if compress_as_float else _byte_length(t) for t in ts_out]


def _decode(compress_as_float, ts_in, ts_out, checksum, prob_bits, into):
    """The batch's decode, one launch of the decode kernel: (out, ok bool
    (B,), sizes int32 (B,), checksum_ok bool (B,)). `out` is the decoded
    (B, W) words (int16 or int32) or bytes; with `into`, the members are
    written straight into ts_out instead, a failing one left as it was,
    `out` and checksum_ok are None, and ok is int32 (1 where a member
    succeeds), read from the kernel's status words with no other op. The
    archives are read where they lie when ``cuda_decode.takes_members``
    holds for them and no checksum is verified (whose stored words the
    staged rows give), else from zero-filled rows of the decode width."""
    B = len(ts_in)
    if B == 0 or len(ts_out) != B:
        raise ValueError(f"need one output per archive, got {B} archives and {len(ts_out)} outputs")
    dev = _device([*ts_in, *ts_out])
    caps = _out_caps(compress_as_float, ts_out)
    L = _bucket_words(max(caps))
    ft = float_type_of(ts_out[0].dtype) if compress_as_float else None
    width = (codec.float_archive_buffer_bytes(ft, L) if compress_as_float
             else ans_encode.archive_buffer_bytes(L))
    dests = ts_out if into else None
    word = C.float_word_size(ft) if compress_as_float else 1
    if into or (not checksum and cuda_decode.takes_members(ts_in)):
        if compress_as_float:
            res = codec.float_decompress_members(ts_in, width // 4, ft, L, prob_bits, dests)
        else:
            res = cuda_decode.ans_decode_members(ts_in, width // 4, prob_bits, L, dests)
        st = res["status"].T
        if into:  # the kernel held each count to its destination's capacity
            return None, st[0], st[1] * word, None
        res["success"], res["size"], _ = cuda_decode.status_fields(res["status"])
        res["checksum_ok"] = torch.ones(B, dtype=torch.bool, device=dev)
    else:
        arcs = _rows([layout.as_bytes(t) for t in ts_in], width)
        if compress_as_float:
            res = codec.float_decompress_batched(arcs.view(torch.int32), ft, L, prob_bits,
                                                 checksum)
        else:
            res = cuda_decode.ans_decode_batched(arcs, prob_bits, L, None, checksum)
    if compress_as_float:
        out = res["out32"].view(_WORD[word])
        sizes_bytes = layout.to_i32(res["size"] * word)
    else:
        out = res["out"]
        sizes_bytes = layout.to_i32(res["size"])
    # the capacities as a scalar, or as a device constant: a tensor made from
    # host ints here would copy from pageable memory, which waits for the decode
    cap = caps[0] if all(c == caps[0] for c in caps) else layout.lengths_tensor(caps, dev)
    ok = res["success"] & (res["size"] <= cap)
    return out, ok, sizes_bytes, res["checksum_ok"]


@entry("front.decompress")
def decompress_members(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    ts_out: Sequence[torch.Tensor],
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    *,
    bits: bool = False,
):
    """:func:`decompress_data` with each member's verdict on the device and
    nothing read back: (outs, ok bool (B,), sizes int32 (B,), checksum_ok
    bool (B,)). checksum_ok is False only where `checksum` is set and a
    member's stored checksum differs from its decoded data's; the caller
    decides what to raise. With `bits`, outs[m] holds ts_out[m]'s dtype as
    :func:`as_bits` gives it (int16 for f16/bf16): the sources a caller
    that copies the outputs on passes to :func:`copy_bits_`."""
    out, ok, sizes_bytes, checksum_ok = _decode(
        compress_as_float, ts_in, ts_out, checksum, prob_bits, into=False)
    dtypes = [_BITS.get(t.dtype, t.dtype) if bits else t.dtype for t in ts_out]
    if len(set(dtypes)) == 1:
        views = _row_views(_view_as(out, dtypes[0]), [t.numel() for t in ts_out])
    else:
        views = [_view_as(out[m], d)[: t.numel()] for m, (t, d) in enumerate(zip(ts_out, dtypes))]
    outs = [v if v.shape == t.shape else v.view(t.shape) for v, t in zip(views, ts_out)]
    return outs, ok, sizes_bytes, checksum_ok


@entry("front.decompress")
def decompress_into(compress_as_float, ts_in, ts_out, prob_bits):
    """Decode each archive straight into ts_out[m], with no checksum and
    nothing read back; a member that fails (status 0) leaves ts_out[m] as
    it was. The caller has made sure that every destination is contiguous
    and whole symbols, every archive readable in place, and that no
    destination overlaps an archive or another destination
    (``torch_api.decodes_in_place``). Returns (status uint8 (B,), sizes
    int32 (B,), temp_mem_used), as :func:`decompress_data` does; counts
    the members as ``direct_members``."""
    _, ok, sizes_bytes, _ = _decode(compress_as_float, ts_in, ts_out, False, prob_bits,
                                    into=True)
    count(DIRECT_MEMBERS, len(ts_out))
    caps = _out_caps(compress_as_float, ts_out)
    return ok.to(torch.uint8), sizes_bytes, ans_decode.decode_scratch_bytes(max(caps), len(ts_in))


@entry("front.decompress")
def decompress_data_simple(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    checksum: bool = False,
):
    """Size-discovery tier: reads the archive headers (host sync),
    allocates exact outputs, then decompresses (DietGpu.cpp:821-911)."""
    infos = get_compressed_info(compress_as_float, ts_in)
    dev = _device(ts_in)
    specs = [
        torch.empty(info["size"], dtype=_DTYPE[info["float_type"]], device=dev)
        if compress_as_float
        else torch.empty(info["total_uncompressed_words"], dtype=torch.uint8, device=dev)
        for info in infos
    ]
    # prob_bits is self-described by the (embedded) ANS header -- the
    # reference never asks the caller for it on decode (GpuANSDecode.cuh:323)
    prob_bits = infos[0]["prob_bits"]
    outs, status, _, _ = decompress_data(
        compress_as_float, ts_in, specs, checksum, prob_bits)
    if not bool(host_read(status.bool().all())):
        raise ValueError("decompression failed")
    return outs


@entry("front.decompress")
def decompress_data_split_size(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    t_out: torch.Tensor,
    split_sizes: Sequence[int],
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Decompress a batch into consecutive splits of one flat output, shaped
    and typed like t_out. Returns (flat, status, sizes, temp_mem).

    Interior split boundaries must keep the 4-byte alignment the compress
    side enforces (GpuANSEncode.cu:131-148, GpuANSDecode.cu)."""
    pieces = _split_pieces(t_out.reshape(-1), split_sizes, "output")
    outs, status, sizes, tm = decompress_data(
        compress_as_float, ts_in, pieces, checksum, prob_bits
    )
    return torch.cat([o.reshape(-1) for o in outs]), status, sizes, tm


@entry("front.decompress")
def decompress_data_stride(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    batch: int,
    stride: int,
    dtype,
    sizes: Sequence[int] | None = None,
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Decompress a batch into the rows of one (batch, stride) tensor
    (BatchProviderStride on the output side). Rows are zero past their
    payload. Returns (out2d, status, sizes_bytes, temp_mem)."""
    sizes = [stride] * batch if sizes is None else [int(s) for s in sizes]
    dev = _device(ts_in)
    specs = [torch.empty(s, dtype=dtype, device=dev) for s in sizes]
    outs, status, sizes_bytes, tm = decompress_data(
        compress_as_float, ts_in, specs, checksum, prob_bits
    )
    out2d = _rows([o.reshape(-1) for o in outs], stride)
    return out2d, status, sizes_bytes, tm


# ---------------------------------------------------------------------------
# archive info
# ---------------------------------------------------------------------------


def get_compressed_info_device(
    compress_as_float: bool, archives: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Archive info on the archives' device, with no host sync: the
    analogue of ansGetCompressedInfoDevice / floatGetCompressedInfoDevice
    (GpuANSInfo.cuh:16-37, GpuFloatInfo.cuh:18-41).

    `archives` is a (B, >=32) uint8 tensor, one archive per row (only the
    header bytes are read). Returns int64 tensors holding u32 values, and
    `valid` as bool:
      float: {size (words), float_type, checksum, valid}
      ans:   {size (words=bytes), prob_bits, checksum, valid}
    """
    if archives.dim() != 2 or archives.dtype != torch.uint8:
        raise ValueError("expects a (B, bytes) u8 archive matrix")
    h = layout.to_u32(archives[:, :32].contiguous().view(torch.int32))
    if compress_as_float:
        return {
            "size": h[:, 1],
            "float_type": h[:, 2] & 0xF,
            "checksum": h[:, 3],
            "valid": h[:, 0] == (C.FLOAT_MAGIC << 16) | C.FLOAT_VERSION,
        }
    return {
        "size": h[:, 2],
        "prob_bits": h[:, 4] & 0xF,
        "checksum": h[:, 5],
        "valid": h[:, 0] == (C.ANS_MAGIC << 16) | C.ANS_VERSION,
    }


def get_compressed_info(compress_as_float: bool, ts_in: Sequence[torch.Tensor]):
    """Parse archive headers on the host. Returns a list of dicts.

    Only the 32 header bytes of each archive travel device-to-host, in one
    batched read for the whole batch (two for float archives, whose
    embedded ANS header sits at a header-dependent offset), as the
    reference reads its info arrays once (DietGpu.cpp:821-911).
    """
    bufs = [layout.as_bytes(t) for t in ts_in]
    if not bufs:
        raise ValueError("need at least one archive")
    if any(b.numel() < 32 for b in bufs):
        raise ValueError("archive too small to hold a header")
    heads = host_read(torch.stack([b[:32] for b in bufs])).numpy()
    if not compress_as_float:
        return [headers.parse_header(h) for h in heads]
    infos = [headers.parse_float_header(h) for h in heads]
    # the embedded ANS archive self-describes its probBits
    # (GpuANSUtils.cuh:205-206), so the _simple tier decodes pb-9/11 float
    # archives without caller hints. Its offset depends on the float
    # header, hence the second read; an offset past the end reads the last
    # 32 bytes, as the JAX package's dynamic_slice clamps it.
    starts = [min(info["ans_start"], b.numel() - 32) for b, info in zip(bufs, infos)]
    ans_heads = host_read(torch.stack([b[s : s + 32] for b, s in zip(bufs, starts)])).numpy()
    for info, ah in zip(infos, ans_heads):
        info["prob_bits"] = headers.parse_header(ah)["prob_bits"]
    return infos
