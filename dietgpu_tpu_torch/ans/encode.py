"""rANS encoder, plain torch: the plain versions of the encode and assembly
kernels, and the archive sections between them.

Counterpart of ``dietgpu_tpu.ans.encode`` (and of the section prefill in
``pallas_encode._encode_stage2``). The encode splits in three steps that
the CUDA path shares, each for B members of one padded length, each with
its own table and length (counterpart of ``ans_encode_batched_pallas``, the
per-member-table encode); a single input is a batch of one:

1. :func:`encode_blocks_batched` -- the interleaved 32-state encode of
   every 4 KiB block and the per-block compaction of the emitted u16 words
   into a staging row (plain version of ``csrc/encode.cu``);
2. :func:`write_sections_batched` -- header, probs, final states,
   blockWords and the 16-byte-aligned exclusive prefix, written into the
   archive buffer (plain version of the sections kernel in
   ``csrc/assembly.cu``; the JAX package keeps this step outside any
   kernel);
3. :func:`assemble_payload_batched` -- each block's staged words copied to
   its prefix offset (plain version of ``csrc/assembly.cu``).

Archive layout (GpuANSUtils.cuh:67-229), u32 words from the archive base:
[0:8) header, [8:136) u16 probs, [136:136+32nb) states, then
round_up(nb,2) (x, y) blockWords pairs, then the payload.
"""

import numpy as np
import torch

from .. import constants as C
from . import layout, stats

S = C.STEPS_PER_BLOCK
W = C.NUM_INTERLEAVED
MW = C.MAX_COMP_WORDS_PER_BLOCK


def archive_buffer_bytes(padded_len: int) -> int:
    """Static archive buffer size for inputs padded to `padded_len` bytes."""
    assert padded_len % C.DEFAULT_BLOCK_SIZE == 0 and padded_len > 0
    nb = padded_len // C.DEFAULT_BLOCK_SIZE
    return C.compressed_overhead(nb) + nb * C.raw_comp_block_max_size(
        C.DEFAULT_BLOCK_SIZE
    )


def encode_scratch_bytes(max_size: int, num_in_batch: int = 1) -> int:
    """Device scratch the reference reserves for a batch encode
    (StackDeviceMemory in ansEncodeBatchDevice, GpuANSEncode.cuh:690-738,
    at its 256-byte granularity, StackDeviceMemory.h:24): the API's
    `temp_mem` for compress, as ``dietgpu_tpu.ans.encode`` reports it. The
    port's allocator owns the real scratch."""

    def align(x):
        return C.round_up(x, 256)

    max_blocks = C.div_up(max_size, C.DEFAULT_BLOCK_SIZE)
    stride = 4 * W + C.raw_comp_block_max_size(C.DEFAULT_BLOCK_SIZE)
    total = align(num_in_batch * C.NUM_SYMBOLS * 16)  # uint4 tables
    total += align(num_in_batch * C.NUM_SYMBOLS * 4)  # histograms
    total += align(num_in_batch * 4)  # checksums
    total += align(num_in_batch * max_blocks * stride)  # uncoalesced blocks
    total += 2 * align(num_in_batch * max_blocks * 4)  # words + prefix
    return total


def encode_table(pdf: torch.Tensor) -> torch.Tensor:
    """The kernel's (512,) int32 table: e1 for the 256 symbols, then magic;
    (B, 512) for a (B, 256) batch of pdfs. With ``stats.normalize_probs``,
    the plain version of the tables kernel (``csrc/stats.cu``)."""
    e1, magic = stats.build_encode_table(pdf)
    return layout.to_i32(torch.cat([e1, magic], -1))


def encode_blocks_batched(data32, length, prob_bits, tables):
    """Plain version of the encode kernel: encode every 4 KiB block of each
    row of `data32` ((B, L/4) int32 packed bytes) with the row's table
    ((B, 512)), the symbols at index >= the row's length not encoded;
    `length` is an int (every row) or a (B,) int64 tensor.

    Returns (staged (B * NBm, 2560) int16, counts (B * NBm,) int32, states
    (B * NBm, 32) int32), member m's block b at row m * NBm + b (NBm =
    L/4096): each block's emitted u16 words in (step, lane) order (zero
    past its count; a count above 2560 means the block overflowed and only
    its first 2560 words are kept), the word counts, and the final lane
    states.
    """
    B = data32.shape[0]
    data = data32.contiguous().view(torch.uint8)
    L = data.shape[1]
    NB = L // C.DEFAULT_BLOCK_SIZE
    dev = data.device
    t = layout.to_u32(tables)
    e1, magic = t[:, :256], t[:, 256:]
    syms = data.long().reshape(B, NB * S * W)
    n = length if isinstance(length, int) else length.to(dev)[:, None]
    valid = (torch.arange(L, device=dev)[None, :] < n).expand(B, L).reshape(B * NB, S, W)
    check_shift = C.ANS_STATE_BITS - prob_bits

    def lookup(tab, sym):  # each member's table at its own blocks' symbols
        return torch.gather(tab, 1, sym.reshape(B, NB * W)).reshape(B * NB, W)

    syms = syms.reshape(B, NB, S, W)
    state = torch.full((B * NB, W), C.ANS_START_STATE, dtype=torch.int64, device=dev)
    vals = torch.zeros((B * NB, S, W), dtype=torch.int64, device=dev)
    mask = torch.zeros((B * NB, S, W), dtype=torch.bool, device=dev)
    for s in range(S):
        sym = syms[:, :, s]
        v = valid[:, s]
        e1v = lookup(e1, sym)
        cdf = e1v & 0xFFF
        pdf = (e1v >> 12) & 0xFFF
        shift = e1v >> 24

        write = v & (state >= (pdf << check_shift))
        vals[:, s] = torch.where(write, state & 0xFFFF, 0)
        mask[:, s] = write
        state = torch.where(write, state >> C.ANS_ENCODED_BITS, state)

        tq = stats.umulhi_u32(state, lookup(magic, sym))
        div = ((tq + state) & layout.U32_MASK) >> shift
        mod = (state - div * pdf) & layout.U32_MASK
        new_state = ((div << prob_bits) + mod + cdf) & layout.U32_MASK
        state = torch.where(v, new_state, state)

    flat_mask = mask.reshape(B * NB, C.DEFAULT_BLOCK_SIZE)
    flat_vals = vals.reshape(B * NB, C.DEFAULT_BLOCK_SIZE)
    counts = flat_mask.sum(dim=1)
    dst = torch.cumsum(flat_mask.long(), dim=1) - 1
    cols = torch.where(flat_mask & (dst < MW), dst, MW)
    staged = torch.zeros((B * NB, MW + 1), dtype=torch.int64, device=dev)
    staged.scatter_(1, cols, torch.where(cols < MW, flat_vals, 0))
    staged = staged[:, :MW]
    staged = torch.where(staged >= 1 << 15, staged - (1 << 16), staged)
    return staged.to(torch.int16), counts.to(torch.int32), layout.to_i32(state)


def write_sections_batched(
    arcs, base32, pdfs, states, counts, lengths, prob_bits, use_checksum=False,
    checksums=None,
):
    """The sections of B archives, archive m at u32 offset base32[m] of row
    m of `arcs` ((B, R) int32, contiguous); `base32` is an int for every
    member or B host ints.

    `pdfs` is (B, 256); `states` (B * NBm, 32) and `counts` (B * NBm,) are
    the encode's outputs, member m's block b at row m * NBm + b, with a
    count of 0 for every block past the member's length; `lengths` is B
    host ints (ragged block counts allowed); `checksums` (B,) when
    `use_checksum`. Each row gets its archive's header, probs, final
    states and blockWords, and the payload prefix is computed.

    The geometry comes from the host lengths, so nothing is read back from
    the device; the B block counts, lengths and offsets it needs on the
    device are a :func:`layout.device_constant` of these arguments, made by
    the first call with them and only read (the section words are built in
    a fresh tensor), so that a CUDA graph captures the call. The torch ops
    are the same few whatever B and the block count are. Members
    at one offset take their sections by slicing, members at their own
    offsets by one scatter. Every
    row takes the states of all NBm blocks, then zeros up to 2
    round_up(NBm, 2) words past them; each member's blockWords are then
    scattered over its own states from word 32 nb on, zero past its blocks.
    What is left of the states and zeros lies at or past the payload
    offset, where the payload overwrites it or past the archive's end: a
    member of nb < NBm blocks gets up to 136 (NBm - nb) bytes written past
    its sections that a per-member copy would not write (8.9 MB for a
    one-block member of a 2^28-byte row, 0 for every member of paths A-E,
    whose members fill their rows).

    Returns (prefix (B, NBm) int32, ds32 list of B host ints (payload u32
    offsets within the rows), ds32 as a (B,) int64 device tensor, sizes
    (B,) int64 archive bytes with SIZE_OVERFLOW_BIT where a block
    overflowed).
    """
    B, R = arcs.shape
    dev = arcs.device
    lengths, base, ds32, NBm, span = section_rows(arcs, counts, lengths, base32)
    st32 = base + 136
    host = section_geometry(lengths, base, prob_bits, use_checksum, dev)

    words = counts.view(B, NBm).long()
    padded = (words + C.WORDS_PER_ALIGN - 1) & ~(C.WORDS_PER_ALIGN - 1)
    incl = torch.cumsum(padded, 1)
    prefix = incl - padded
    total = incl[:, -1]

    pdfs = layout.to_u32(pdfs)
    sections = layout.to_i32(torch.cat([host[:8].T, pdfs[:, 0::2] | (pdfs[:, 1::2] << 16)], 1))
    sections[:, 3] = total  # below 2^31
    if use_checksum:
        sections[:, 5] = checksums
    if (base == base[0]).all():
        b, s = int(base[0]), int(st32[0])
        arcs[:, b:s] = sections
        arcs[:, s : s + NBm * W] = states.view(B, NBm * W)
        arcs[:, s + NBm * W : s + span] = 0
    else:
        zeros = torch.zeros((B, span - NBm * W), dtype=torch.int32, device=dev)
        cols = host[11][:, None] + torch.arange(136 + span, device=dev)
        arcs.scatter_(1, cols, torch.cat([sections, states.view(B, NBm * W), zeros], 1))
    # blockWords (x, y) = ((uncompressed bytes << 16) | words, prefix) for
    # the member's blocks, zero after them (the pair that makes the count
    # even among them); all below 2^31
    uncomp = (host[2][:, None] - torch.arange(NBm, device=dev) * C.DEFAULT_BLOCK_SIZE).clamp(
        0, C.DEFAULT_BLOCK_SIZE)
    bw = torch.stack([(uncomp << 16) | words, torch.where(uncomp > 0, prefix, 0)], 2)
    cols = host[9][:, None] + torch.arange(2 * NBm, device=dev)
    arcs.scatter_(1, cols, bw.view(B, 2 * NBm).to(torch.int32))

    sizes = host[10] + 2 * total  # total u16 words, a multiple of 8
    overflow = (words > MW).any(1)
    sizes = torch.where(overflow, sizes | C.SIZE_OVERFLOW_BIT, sizes)
    return prefix.to(torch.int32), ds32.tolist(), host[8], sizes


def section_rows(arcs, counts, lengths, base32):
    """The host side of the sections of B archives in the rows of `arcs`
    ((B, R)), as :func:`write_sections_batched` and the sections kernel
    take them: (lengths and archive u32 offsets as (B,) int64 numpy arrays,
    the payload u32 offsets ds32 likewise, the blocks a member NBm, the
    words from the states to the end of the zero tail). Raises ValueError
    where a row is too short for its sections."""
    B, R = arcs.shape
    NBm = counts.shape[0] // B
    lengths = np.asarray(lengths, dtype=np.int64).reshape(B)
    base = np.broadcast_to(np.asarray(base32, dtype=np.int64), (B,))
    nbs = -(-lengths // C.DEFAULT_BLOCK_SIZE)
    st32 = base + 136
    ds32 = st32 + nbs * W + 2 * (nbs + (nbs & 1))
    span = NBm * W + 2 * C.round_up(NBm, 2)
    if int(st32.max()) + span > R:
        raise ValueError("write_sections: the rows are too short for the sections")
    return lengths, base, ds32, NBm, span


def section_geometry(lengths, base32, prob_bits, use_checksum, dev):
    """What :func:`write_sections_batched` takes from the host for archives
    of `lengths` (B ints) at u32 offsets `base32` (an int or B ints), as a
    read-only (12, B) int64 :func:`layout.device_constant` on `dev`: the
    header's eight words (the total, row 3, and the checksum, row 5, are 0:
    the caller fills them in on the device), then the payload and
    blockWords u32 offsets, the archive bytes before the payload, and the
    archive offsets."""
    lengths = np.asarray(lengths, dtype=np.int64)
    base = np.broadcast_to(np.asarray(base32, dtype=np.int64), lengths.shape)

    def make():
        nbs = -(-lengths // C.DEFAULT_BLOCK_SIZE)
        bw32 = base + 136 + nbs * W
        ds32 = bw32 + 2 * (nbs + (nbs & 1))
        head = np.zeros((12, len(lengths)), np.int64)
        head[0], head[1], head[2], head[4], head[8], head[9], head[10], head[11] = (
            (C.ANS_MAGIC << 16) | C.ANS_VERSION, nbs, lengths,
            prob_bits | (int(use_checksum) << 4), ds32, bw32, 4 * (ds32 - base), base)
        return head

    key = ("sections", layout.ints_key(lengths), layout.ints_key(base), prob_bits,
           bool(use_checksum))
    return layout.device_constant(key, dev, make)


def assemble_payload_batched(arcs, ds32, staged, counts, prefix):
    """Plain version of the assembly kernel: copy each block's staged words,
    zero-padded to a multiple of 8 u16, into row m of `arcs` ((B, R) int32)
    at u32 offset ds32 + prefix[m, b] / 2, member m with its own prefix row
    ((B, nb) int32) and payload offset (`ds32` an int for every member or a
    (B,) int64 tensor), its blocks at rows m * NBm + b of `staged` and
    `counts` (NBm = rows / B). Copies are clamped to the staging row and to
    each row of `arcs`."""
    B, nb = prefix.shape
    if nb == 0:
        return
    R = arcs.shape[1]
    NBm = staged.shape[0] // B
    dev = arcs.device
    rows = (torch.arange(B, device=dev)[:, None] * NBm + torch.arange(nb, device=dev)).reshape(-1)
    w = counts[rows].long()[:, None]
    st32 = layout.to_u32(staged[rows].contiguous().view(torch.int32))
    j = torch.arange(MW // 2, device=dev)[None, :]
    lo = torch.where(2 * j < w, st32 & 0xFFFF, 0)
    hi = torch.where(2 * j + 1 < w, st32 & 0xFFFF0000, 0)
    n32 = ((w + C.WORDS_PER_ALIGN - 1) & ~(C.WORDS_PER_ALIGN - 1)).clamp(max=MW) // 2
    ds = ds32 if isinstance(ds32, int) else ds32.to(dev)[:, None]
    col = (ds + prefix.long() // 2).reshape(-1, 1) + j
    member = rows[:, None] // NBm
    keep = (j < n32) & (col < R)
    arcs.view(-1)[(member * R + col)[keep]] = layout.to_i32((lo | hi)[keep])
