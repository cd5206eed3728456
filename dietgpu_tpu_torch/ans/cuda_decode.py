"""Fused rANS decode: the three configurations of the decode kernel
(``csrc/decode.cu``) and their plain versions.

Counterpart of ``dietgpu_tpu.ans.pallas_decode.ans_decode_padded_pallas``:

- ``decode_float_*`` with ``fuse_float`` in {FLOAT16, BFLOAT16, FLOAT32},
  run on the float container at its embedded ANS archive (``arc_base`` =
  4 + round_up(n, 16)/4 u32 for f16/bf16, 4 + round_up(n, 8)/2 +
  round_up(n, 16)/4 for f32);
- ``decode_raw_*`` with ``fuse_float=None`` on a bare ANS archive, and the
  raw-ANS entry point :func:`ans_decode_padded` (counterpart of
  ``dietgpu_tpu.backend.ans_decode_padded``).

The kernel decodes B archives, rows of one (B, stride) buffer, with one
launch, each member with its own table (counterpart of
``ans_decode_batched_pallas`` and of the fused decode inside
``float_decompress_batched_pallas``); a single archive is a batch of one.
:func:`ans_decode_batched` is the raw-ANS batch entry point. Member sizes
may be ragged; each member's comes from its own header.

:func:`decode_members` takes the same batch as B archives read where they
lie, and writes each member into a row of a new buffer or straight into
a destination of its own: the kernel's descriptor form (one descriptor a
member, in the launch parameters up to :data:`INLINE` members, else
copied to the card through pinned memory, which is why a capture takes no
more: :func:`takes_members`). :func:`ans_decode_members` is its raw-ANS
entry point.

The kernel parses the headers and builds the decode LUT on the device, so
the decode needs no host round trip; the plain versions do the same in
torch. The raw entry points run inside the span ``ans.decode``; the float
decode runs inside its caller's ``float.fused_decode_join[_f32]``. A CUDA
tensor goes through the kernel; a CPU tensor through the plain version.
"""

import numpy as np
import torch

from .. import _build
from .. import constants as C
from ..floatcodec import split
from ..profiling import annotate, host_read
from . import checksum, layout
from . import decode as plain_decode

FLOAT_TYPES = (*split.HALF_TYPES, C.FLOAT_TYPE_FLOAT32)
# a member of the kernel's descriptor form (csrc/decode.cu: Desc)
DESC = np.dtype([("arc", "<u8"), ("out", "<u8"), ("alen", "<u4"), ("cap", "<u4")])
INLINE = 128  # descriptors a launch carries in its parameters (csrc/decode.cu: kInline)
U32_LIMIT = 1 << 32  # a descriptor's archive words and output symbols stay below it
# float type (None: raw ANS archives) -> the kernel's launch counter
_KERNEL = {None: "decode_raw", C.FLOAT_TYPE_FLOAT32: "decode_f32"}


def _check(out_max, prob_bits, float_type, a32=None, arcs=None):
    """The one check of a decode's arguments, in every entry point and both
    forms: prob_bits, the capacity `out_max` (symbols a member, a positive
    multiple of 4096), the float type (None for raw ANS archives) and, for
    float containers, rows of `a32` >= 4 words. `arcs`, where given, are
    the strided form's rows (their width is `a32`): a (B, A/4) int32
    tensor, B > 0."""
    if arcs is not None:
        if arcs.dtype != torch.int32 or arcs.dim() != 2 or arcs.shape[0] == 0:
            raise ValueError("decode: the archives must be a (B, A/4) int32 tensor, B > 0")
        a32 = arcs.shape[1]
    if prob_bits not in C.SUPPORTED_PROB_BITS:
        raise ValueError(f"prob_bits {prob_bits} not in {C.SUPPORTED_PROB_BITS}")
    if out_max <= 0 or out_max % C.DEFAULT_BLOCK_SIZE:
        raise ValueError(f"decode: capacity {out_max} is not a positive multiple of 4096")
    if float_type is not None and float_type not in FLOAT_TYPES:
        raise ValueError(f"decode: float type {float_type} is not f16/bf16/f32")
    if float_type is not None and a32 < 4:
        raise ValueError("decode: a float container has at least 4 words")


def _rows_section(arcs, off32, n32):
    """arcs[m, off32[m] : off32[m] + n32] for each row (off32: B host ints),
    zero-filled past the row's end."""
    B, A32 = arcs.shape
    idx = torch.from_numpy(np.asarray(off32, np.int64)).to(arcs.device)[:, None]
    idx = idx + torch.arange(n32, device=arcs.device)
    v = torch.gather(arcs, 1, idx.clamp(max=A32 - 1))
    return torch.where(idx < A32, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _digest(out32, with_digest):
    """Folded XOR of each row of out32 (or of the 1-D out32), or 0."""
    if with_digest:
        return checksum._fold8(checksum.xor_reduce(out32))
    return torch.zeros(out32.shape[:-1], dtype=torch.int64, device=out32.device)


def decode_float_plain(
    arc32, float_type, out_max_words, prob_bits, static_length=None, with_digest=False
):
    """Plain version of the decode kernel's float configurations.

    Returns (out32, success bool, size int64 (the header's word count),
    digest int64 (folded XOR of out32, or 0)), all 0-dim tensors but
    out32, on the archive's device. out32 is (Lw/2,) int32 word pairs for
    f16/bf16 and (Lw,) int32 words for f32, zero past the word count.
    """
    out = decode_float_batched_plain(arc32[None], float_type, out_max_words, prob_bits,
                                     static_length, with_digest)
    return tuple(x[0] for x in out)


def status_fields(status):
    """(success bool, size int64, digest int64), each (B,), from a batch's
    (B, 3) int32 status words as the kernel writes them."""
    st = layout.to_u32(status.T)
    return st[0] != 0, st[1], st[2]


def decode_float(
    arc32, float_type, out_max_words, prob_bits, static_length=None, with_digest=False
):
    """:func:`decode_float_plain` of one container, through the kernel (a
    batch of one) for a CUDA tensor."""
    out = decode_float_batched(arc32[None], float_type, out_max_words, prob_bits,
                               static_length, with_digest)
    return tuple(x[0] for x in out)


def decode_raw_plain(arc32, prob_bits, out_max, with_digest=False):
    """Plain version of the decode kernel's raw-byte configuration.

    Returns (out32 (out_max/4,) int32 packed bytes, zero past each block's
    symbols, success bool (magic, prob_bits, header byte count <=
    out_max), size int64 (the header's byte count), digest int64 (folded
    XOR of out32, or 0)), on the archive's device.
    """
    _check(out_max, prob_bits, None, arcs=arc32[None])
    res = plain_decode.ans_decode_padded(arc32, prob_bits, out_max)
    out32 = layout.u8_to_u32le(res["out"])
    return out32, res["success"], res["size"], _digest(out32, with_digest)


def ans_decode_padded(archive, prob_bits, out_max, verify_checksum=False):
    """Decode a raw ANS archive.

    `archive` is (A/4,) int32 u32 words or (A,) uint8 bytes, A % 4 == 0;
    bytes past the archive are ignored. `out_max` is the output capacity in
    bytes, a positive multiple of 4096.

    Returns dict, on the archive's device: out ((out_max,) uint8, a view of
    the kernel's packed output; zero past each block's symbols), size
    (int64, the header's byte count), success (the header's magic and
    prob_bits match and size <= out_max), checksum_ok (False only when
    `verify_checksum`, the archive carries a checksum, and the output's
    digest differs from it).
    """
    arc32 = archive
    if archive.dtype == torch.uint8:
        if archive.dim() != 1 or archive.shape[0] % 4:
            raise ValueError("ans decode: a byte archive must be 1-D with A % 4 == 0")
        arc32 = layout.u8_to_u32le(archive.contiguous())
    with annotate("ans.decode", arc32.is_cuda):
        if arc32.is_cuda:
            out32, success, size, digest = (x[0] for x in decode_raw_batched_cuda(
                arc32[None], prob_bits, out_max, None, verify_checksum))
        else:
            out32, success, size, digest = decode_raw_plain(arc32, prob_bits, out_max,
                                                            verify_checksum)
    checksum_ok = torch.ones((), dtype=torch.bool, device=arc32.device)
    if verify_checksum and arc32.shape[0] >= 6:
        checksum_ok = checksum.verified(arc32[4:6], digest)
    return {
        "out": layout.u32_to_u8le(out32),
        "size": size,
        "success": success,
        "checksum_ok": checksum_ok,
    }


# ---- batched: B archives, rows of one (B, stride) buffer, one launch ----


def static_block_count(static_length, out_max_words):
    """The block count a static length fixes (as float_decompress_batched_pallas
    passes static_nb), or None."""
    if static_length is None:
        return None
    return C.div_up(min(static_length, out_max_words), C.DEFAULT_BLOCK_SIZE)


def decode_float_batched_plain(
    arcs, float_type, out_max_words, prob_bits, static_length=None, with_digest=False,
    static_nb=None,
):
    """Plain version of the per-member-table float decode: each row of
    `arcs` ((B, F4) int32) decoded as :func:`decode_float_plain` decodes
    one container, reading nothing past its row; with `static_nb` (the
    batched path's, from :func:`static_block_count`) the block geometry comes from
    it and each member's block count must match. Returns (out32 (B, Lw/2)
    or (B, Lw), success (B,), size (B,), digest (B,))."""
    _check(out_max_words, prob_bits, float_type, arcs=arcs)
    Lw = out_max_words
    B = arcs.shape[0]
    dev = arcs.device
    u = layout.to_u32(arcs)
    h = host_read(u[:, :4], plain=True).tolist()
    n = np.array([layout.as_i32(r[1]) for r in h], np.int64)
    ok = np.array(
        [r[0] == (C.FLOAT_MAGIC << 16) | C.FLOAT_VERSION and (r[2] & 0xF) == float_type
         for r in h]
    ) & (n <= Lw)
    if static_length is not None:
        ok &= n == min(static_length, Lw)
    n_eff = np.clip(n, 0, Lw)

    f32 = float_type == C.FLOAT_TYPE_FLOAT32
    hi_base = 4 + (n_eff + 7) // 8 * 4
    base = hi_base + (n_eff + 15) // 16 * 4 if f32 else 4 + (n_eff + 15) // 16 * 4
    res = plain_decode.decode_rows(u, prob_bits, Lw, base=base, static_nb=static_nb)
    size, success = host_read(torch.stack([res["size"], res["success"].long()]), plain=True)
    sizes = np.array([layout.as_i32(v) for v in size.tolist()], np.int64)
    ok &= success.numpy().astype(bool) & (sizes == n_eff)

    comp = res["out"]
    if f32:
        lo = _rows_section(arcs, [4] * B, Lw // 2).view(torch.int16)
        hi = _rows_section(arcs, hi_base, Lw // 4).view(torch.uint8)
        words = split.join_words(comp, (lo, hi), float_type)
    else:
        nc = _rows_section(arcs, [4] * B, Lw // 4).view(torch.uint8)
        words = split.join_words(comp, (nc,), float_type)
    n_t = torch.from_numpy(n_eff).to(dev)[:, None]
    valid = torch.arange(Lw, device=dev)[None, :] < n_t
    words = torch.where(valid, words, torch.zeros((), dtype=words.dtype, device=dev))
    out32 = words.view(torch.int32)
    return (
        out32,
        torch.from_numpy(ok).to(dev),
        torch.tensor([r[1] for r in h], dtype=torch.int64, device=dev),
        _digest(out32, with_digest),
    )


def decode_float_batched_cuda(
    arcs, float_type, out_max_words, prob_bits, static_length=None, with_digest=False,
    static_nb=None,
):
    """Launch the f16/bf16 or f32 configuration of ``csrc/decode.cu``, one
    launch for all B rows; same contract as
    :func:`decode_float_batched_plain`."""
    out32, status = _launch(arcs.device, out_max_words, prob_bits, float_type, arcs=arcs,
                            static_length=static_length, static_nb=static_nb,
                            with_digest=with_digest)
    return (out32, *status_fields(status))


def decode_float_batched(
    arcs, float_type, out_max_words, prob_bits, static_length=None, with_digest=False,
    static_nb=None,
):
    fn = decode_float_batched_cuda if arcs.is_cuda else decode_float_batched_plain
    return fn(arcs, float_type, out_max_words, prob_bits, static_length, with_digest,
              static_nb)


def decode_raw_batched_plain(arcs, prob_bits, out_max, static_nb=None, with_digest=False):
    """Plain version of the per-member-table raw-byte decode: each row of
    `arcs` ((B, A/4) int32) decoded as :func:`decode_raw_plain` decodes one
    archive, reading nothing past its row. Returns (out32 (B, out_max/4),
    success (B,), size (B,), digest (B,))."""
    _check(out_max, prob_bits, None, arcs=arcs)
    res = plain_decode.decode_rows(layout.to_u32(arcs), prob_bits, out_max,
                                   static_nb=static_nb)
    out32 = res["out"].view(torch.int32)
    return out32, res["success"], res["size"], _digest(out32, with_digest)


def decode_raw_batched_cuda(arcs, prob_bits, out_max, static_nb=None, with_digest=False):
    """Launch the raw-byte configuration of ``csrc/decode.cu``, one launch
    for all B rows; same contract as :func:`decode_raw_batched_plain`."""
    out32, status = _launch(arcs.device, out_max, prob_bits, None, arcs=arcs,
                            static_nb=static_nb, with_digest=with_digest)
    return (out32, *status_fields(status))


def ans_decode_batched(archives, prob_bits, out_max, static_nb=None, verify_checksum=False):
    """Decode B raw ANS archives with one launch.

    Counterpart of ``dietgpu_tpu.ans.pallas_decode.ans_decode_batched_pallas``.
    `archives` is (B, A/4) int32 u32 words or (B, A) uint8 bytes, member
    m's archive at the start of row m; the row length is the member stride,
    and nothing past a member's row is read. `out_max` is each member's
    output capacity in bytes, a positive multiple of 4096; the members'
    sizes may be ragged, each read from its own header on the device.
    `static_nb`, if given, is every member's block count: the geometry
    comes from it and a member whose header disagrees fails `success`.

    Returns dict, on the archives' device: out ((B, out_max) uint8, zero
    past each block's symbols), size ((B,) int64 header byte counts),
    success ((B,) bool), checksum_ok ((B,) bool; False only when
    `verify_checksum`, the member carries a checksum, and its output's
    digest differs from it).
    """
    arcs = archives
    if archives.dtype == torch.uint8:
        if archives.dim() != 2 or archives.shape[1] % 4:
            raise ValueError("ans decode: a byte batch must be (B, A) with A % 4 == 0")
        arcs = archives.contiguous().view(torch.int32)
    fn = decode_raw_batched_cuda if arcs.is_cuda else decode_raw_batched_plain
    with annotate("ans.decode", arcs.is_cuda):
        out32, success, size, digest = fn(arcs, prob_bits, out_max, static_nb, verify_checksum)
    checksum_ok = torch.ones(arcs.shape[0], dtype=torch.bool, device=arcs.device)
    if verify_checksum and arcs.shape[1] >= 6:
        checksum_ok = checksum.verified(arcs[:, 4:6], digest)
    return {
        "out": out32.view(torch.uint8),
        "size": size,
        "success": success,
        "checksum_ok": checksum_ok,
    }


# ---- the descriptor form: B archives read where they lie, one launch ----


def symbol_bytes(float_type) -> int:
    """Bytes of one decoded symbol: a raw byte (float_type None), or a word."""
    return 1 if float_type is None else C.float_word_size(float_type)


def takes_members(archives, outs=None, sym=1) -> bool:
    """Whether the descriptor form can take these members where they lie:
    every archive contiguous, 4-byte aligned and whole u32 words; every
    output, where given, contiguous, aligned to and a whole number of
    `sym`-byte symbols, fewer than 2^32 of them; and, inside a CUDA graph
    capture, at most :data:`INLINE` members, since a larger table is
    copied from host memory that does not outlive the call (as
    ``layout.device_constant`` refuses)."""
    if (len(archives) > INLINE and archives[0].is_cuda
            and torch.cuda.is_current_stream_capturing()):
        return False
    if not all(a.is_contiguous() and not (a.data_ptr() | a.nbytes) & 3 for a in archives):
        return False
    return outs is None or all(
        o.is_contiguous() and not (o.data_ptr() % sym or o.nbytes % sym)
        and o.nbytes < U32_LIMIT * sym for o in outs)


def _descriptors(archives, a32, out_max, prob_bits, float_type, outs):
    """Check a member decode's arguments, and return each member's (archive
    address, output address or 0 without `outs`, read words, capacity in
    symbols): the kernel's descriptors (:data:`DESC`)."""
    if not archives or (outs is not None and len(outs) != len(archives)):
        raise ValueError("member decode: need B > 0 archives and, if given, one output per "
                         "archive")
    _check(out_max, prob_bits, float_type, a32)
    if out_max >= U32_LIMIT or not 0 < a32 < U32_LIMIT:
        raise ValueError(f"member decode: capacity {out_max} or a row of {a32} words "
                         "is not below 2^32")
    sym = symbol_bytes(float_type)
    if not takes_members(archives, outs, sym):
        raise ValueError("member decode: the members do not meet takes_members")
    if outs is None:
        return np.array([(a.data_ptr(), 0, min(a.nbytes >> 2, a32), out_max)
                         for a in archives], DESC)
    if any(o.nbytes > out_max * sym for o in outs):
        raise ValueError("member decode: an output holds more symbols than the capacity")
    return np.array([(a.data_ptr(), o.data_ptr(), min(a.nbytes >> 2, a32), o.nbytes // sym)
                     for a, o in zip(archives, outs)], DESC)


def decode_members(archives, a32, out_max, prob_bits, float_type=None, outs=None):
    """Decode B archives, each read where it lies, with one launch: the
    descriptor form of ``csrc/decode.cu``.

    `archives` are B tensors whose bytes are the archives (of any dtype);
    member m's is read as the row of `a32` u32 that a zero-filled staging
    buffer of that width would hold: its first min(words, a32) words, then
    zeros. The archives and outputs must meet :func:`takes_members`, else
    ValueError.
    `float_type` None decodes raw ANS archives into `out_max` bytes a
    member, a float type its containers into `out_max` words (out_max a
    positive multiple of 4096). `outs` None decodes into a new (B, out_max *
    symbol bytes / 4) int32 buffer, as the strided batch does; else B
    tensors, each written in place up to its own size in
    symbols (zeros past the header's count, as in the buffer), and left as
    it was where its member fails.

    Returns (out32 or None when `outs` is given, status): status is the
    kernel's (B, 3) int32 words a member, success (1 where the header's
    checks pass and its count fits the output), the header's count (its
    u32 bits) and 0; :func:`status_fields` reads them. Archives on the card
    go through the kernel, archives on the CPU through its plain
    version."""
    descs = _descriptors(archives, a32, out_max, prob_bits, float_type, outs)
    if archives[0].is_cuda:
        return _launch(archives[0].device, out_max, prob_bits, float_type, a32=a32,
                       descs=descs, in_place=outs is not None)
    return _members_plain(archives, a32, out_max, prob_bits, float_type, outs)


def _launch(dev, out_max, prob_bits, float_type, a32=None, arcs=None, descs=None,
            in_place=False, static_length=None, static_nb=None, with_digest=False):
    """The one launch of ``csrc/decode.cu`` for a batch on device `dev`,
    in either form: the strided rows `arcs` ((B, A/4) int32, checked
    here), or B descriptors `descs` (:data:`DESC`, from
    :func:`_descriptors`) of rows of `a32` words, whose outputs are rows of
    a new buffer unless `in_place`. Returns (out32: (B, out_max * symbol
    bytes / 4) int32, or None when `in_place`; status: the kernel's (B, 3)
    int32 words)."""
    if arcs is not None:
        _check(out_max, prob_bits, float_type, arcs=arcs)
        _build.check_cuda_tensor(arcs, "decode archives", torch.int32, align=4)
        a32 = arcs.shape[1]
    B = len(descs) if arcs is None else arcs.shape[0]
    row = out_max * symbol_bytes(float_type)  # bytes of a member's output row
    out32 = None if in_place else torch.empty((B, row // 4), dtype=torch.int32, device=dev)
    status = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    host = table = None
    if descs is not None:
        if out32 is not None:  # each member's row of the new buffer
            descs["out"] = out32.data_ptr() + row * np.arange(B, dtype=np.uint64)
        if B > INLINE:  # one copy on the stream from pinned memory, never inside a capture
            table = torch.from_numpy(descs.view(np.uint8)).pin_memory().to(dev, non_blocking=True)
        else:
            host = descs.ctypes.data
    _build.launch(
        _KERNEL.get(float_type, "decode"), layout.data_ptr(arcs), B, a32,
        layout.data_ptr(out32), out_max // C.DEFAULT_BLOCK_SIZE, float_type or 0, prob_bits,
        -1 if static_length is None else static_length, -1 if static_nb is None else static_nb,
        int(with_digest), status.data_ptr(), host, layout.data_ptr(table), int(in_place),
    )
    return out32, status


def _members_plain(archives, a32, out_max, prob_bits, float_type, outs):
    """The plain version: each archive staged into a zero-filled row of
    a32 words, the strided plain decode, then each succeeding member's
    symbols copied into its output."""
    B = len(archives)
    dev = archives[0].device
    rows = torch.zeros((B, a32), dtype=torch.int32, device=dev)
    row_bytes = rows.view(torch.uint8)
    for m, a in enumerate(archives):
        n = min(a.nbytes, 4 * a32)
        row_bytes[m, :n] = layout.as_bytes(a)[:n]
    if float_type is None:
        out32, success, size, _ = decode_raw_batched_plain(rows, prob_bits, out_max)
    else:
        out32, success, size, _ = decode_float_batched_plain(rows, float_type, out_max,
                                                             prob_bits)
    dsts = None if outs is None else [layout.as_bytes(o) for o in outs]
    caps = out_max if outs is None else torch.tensor(
        [d.numel() // symbol_bytes(float_type) for d in dsts], device=dev)
    success = success & (size <= caps)
    status = torch.stack([success.to(torch.int32), size.to(torch.int32),
                          torch.zeros_like(size, dtype=torch.int32)], 1)
    if outs is None:
        return out32, status
    for m, ok in enumerate(host_read(success, plain=True).tolist()):
        if ok:
            dsts[m].copy_(out32[m].view(torch.uint8)[: dsts[m].numel()])
    return None, status


def ans_decode_members(archives, a32, prob_bits, out_max, outs=None):
    """:func:`ans_decode_batched` of B raw ANS archives read where they lie
    (:func:`decode_members`), with no checksum; `outs` as there. Returns
    dict: out ((B, out_max) uint8, or None with `outs`) and status, the
    (B, 3) int32 words that :func:`status_fields` reads."""
    with annotate("ans.decode", archives[0].is_cuda):
        out32, status = decode_members(archives, a32, out_max, prob_bits, None, outs)
    return {"out": None if out32 is None else out32.view(torch.uint8), "status": status}
