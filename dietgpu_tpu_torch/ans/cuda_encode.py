"""rANS encode on the card: the tables kernel (``csrc/stats.cu``: the
probability quantization and the encode table), the encode kernel
(``csrc/encode.cu``), the sections and assembly kernels
(``csrc/assembly.cu``), and the raw-ANS entry points that put the
histogram kernel (``csrc/hist.cu``) in front of them.

Counterpart of ``dietgpu_tpu.ans.pallas_encode`` (``_encode_stage1``,
``_encode_stage2``, ``_encode_finish``, ``ans_encode_padded_pallas``,
``ans_encode_batched_pallas``) and of the XLA ops between its kernels
(``stats.normalize_probs``, ``build_encode_table``, the section prefill).
A CUDA tensor goes through the kernels; a CPU tensor through their plain
versions in :mod:`.stats`, :mod:`.encode` and :mod:`.cuda_hist`, which are
also the plain pipeline that the chip check runs on the card.

Every step works on B members, rows of one (B, L/4) buffer, each with its
own table and length, with one launch of each kernel whatever B is (the
per-member-table encode and the batched assembly). A single input is a
batch of one: :func:`ans_encode_padded` and :func:`ans_encode_batched`
run the same code. The histogram pass runs inside the span ``ans.hist``.
"""

import torch

from .. import _build
from .. import constants as C
from ..profiling import annotate, host_read
from . import cuda_hist
from . import encode as plain_encode
from . import layout, stats


def quantize_cuda(hist, total, prob_bits):
    """Launch ``csrc/stats.cu`` on B members' counts, one launch for all:
    `hist` is (B, 256) int32 on the card, `total` an int for every member
    or a (B,) int64 tensor on the card. Returns (pdfs (B, 256) int32,
    tables (B, 512) int32), bit for bit ``stats.normalize_probs`` (its low
    32 bits) and ``encode.encode_table`` of it."""
    if prob_bits not in C.SUPPORTED_PROB_BITS:
        raise ValueError(f"prob_bits {prob_bits} not in {C.SUPPORTED_PROB_BITS}")
    B = _check_symbols(hist, "tables counts")
    scalar = isinstance(total, int)
    if not scalar:
        _build.check_cuda_tensor(total, "tables totals", torch.int64, B, align=8)
    pdfs = torch.empty((B, C.NUM_SYMBOLS), dtype=torch.int32, device=hist.device)
    tables = torch.empty((B, 2 * C.NUM_SYMBOLS), dtype=torch.int32, device=hist.device)
    _build.launch("tables", hist.data_ptr(), None, B, total if scalar else 0,
                  None if scalar else total.data_ptr(), prob_bits, pdfs.data_ptr(),
                  tables.data_ptr())
    return pdfs, tables


def encode_table_cuda(pdfs):
    """Launch ``csrc/stats.cu`` on B members' weights ((B, 256) int32 on
    the card): the (B, 512) int32 tables alone, bit for bit
    ``encode.encode_table``."""
    B = _check_symbols(pdfs, "tables weights")
    tables = torch.empty((B, 2 * C.NUM_SYMBOLS), dtype=torch.int32, device=pdfs.device)
    _build.launch("tables", None, pdfs.data_ptr(), B, 0, None, 0, None, tables.data_ptr())
    return tables


def _check_symbols(t, what):
    """B, for a (B, 256) int32 tensor on the card."""
    if t.dim() != 2 or t.shape[1] != C.NUM_SYMBOLS:
        raise ValueError(f"{what}: expected (B, {C.NUM_SYMBOLS}), got {tuple(t.shape)}")
    _build.check_cuda_tensor(t, what, torch.int32, align=4)
    return t.shape[0]


def quantize(hist, total, prob_bits, plain):
    """(pdfs, tables) of B members' counts ((B, 256), any integer dtype;
    `total` as :func:`quantize_cuda` takes it), as the encode takes them:
    the tables kernel on the counts' low 32 bits, or for `plain` its plain
    version (``stats.normalize_probs``, then ``encode.encode_table``)."""
    if not plain:
        return quantize_cuda(hist.to(torch.int32).contiguous(), total, prob_bits)
    pdfs = stats.normalize_probs(hist, total, prob_bits)
    return pdfs, plain_encode.encode_table(pdfs)


def encode_blocks_batched_cuda(data32, length, prob_bits, tables):
    """Launch ``csrc/encode.cu``, one launch for all B members; same
    contract as :func:`encode.encode_blocks_batched` (`length` an int for
    every member or a (B,) int64 tensor on the card) except that staging
    words past a block's count are left unwritten."""
    B, n4 = data32.shape
    NBm = n4 * 4 // C.DEFAULT_BLOCK_SIZE
    _build.check_cuda_tensor(data32, "encode data", torch.int32, B * NBm * 1024)
    _build.check_cuda_tensor(tables, "encode tables", torch.int32, B * 512, align=4)
    scalar = isinstance(length, int)
    if not scalar:
        _build.check_cuda_tensor(length, "encode lengths", torch.int64, B, align=8)
    dev = data32.device
    staged = torch.empty((B * NBm, plain_encode.MW), dtype=torch.int16, device=dev)
    counts = torch.empty(B * NBm, dtype=torch.int32, device=dev)
    states = torch.empty((B * NBm, C.NUM_INTERLEAVED), dtype=torch.int32, device=dev)
    _build.launch(
        "encode", data32.data_ptr(), B, NBm, length if scalar else 0,
        None if scalar else length.data_ptr(), prob_bits, tables.data_ptr(),
        staged.data_ptr(), counts.data_ptr(), states.data_ptr(),
    )
    return staged, counts, states


def assemble_payload_batched_cuda(arcs, ds32, staged, counts, prefix):
    """Launch ``csrc/assembly.cu``, one launch for all B members; same
    contract as :func:`encode.assemble_payload_batched` (`ds32` an int for
    every member or a (B,) int64 tensor on the card). Each payload offset
    must be a multiple of 4 u32."""
    B, nb = prefix.shape
    if nb == 0:
        return
    _build.check_cuda_tensor(arcs, "assembly archives", torch.int32)
    if arcs.dim() != 2 or arcs.shape[0] != B or arcs.shape[1] % 4:
        raise ValueError("assembly: the archives must be B rows of a multiple of 16 bytes")
    scalar = isinstance(ds32, int)
    if scalar and ds32 % 4:
        raise ValueError("assembly: payload offset must be 16-byte aligned")
    if not scalar:
        _build.check_cuda_tensor(ds32, "assembly offsets", torch.int64, B, align=8)
    _build.check_cuda_tensor(staged, "assembly staged", torch.int16, B * nb * plain_encode.MW)
    _build.check_cuda_tensor(counts, "assembly counts", torch.int32, B * nb, align=4)
    _build.check_cuda_tensor(prefix, "assembly prefix", torch.int32, B * nb, align=4)
    _build.launch(
        "assembly", staged.data_ptr(), counts.data_ptr(), prefix.data_ptr(), B, nb,
        arcs.data_ptr(), arcs.shape[1], ds32 if scalar else 0,
        None if scalar else ds32.data_ptr(),
    )


def write_sections_batched_cuda(
    arcs, base32, pdfs, states, counts, lengths, prob_bits, use_checksum=False,
    checksums=None,
):
    """Launch the sections kernel (``csrc/assembly.cu``), one launch for
    all B members; same contract and return as
    :func:`encode.write_sections_batched` (`pdfs` (B, 256) int32,
    `checksums` (B,) int32 when `use_checksum`, every tensor on the card),
    and the same words written into `arcs`. The geometry is the same
    read-only :func:`encode.section_geometry`, so nothing is read back and
    a CUDA graph captures the call."""
    _build.check_cuda_tensor(arcs, "sections archives", torch.int32)
    if arcs.dim() != 2 or arcs.shape[1] % 4:
        raise ValueError("sections: the archives must be B rows of a multiple of 16 bytes")
    B, R = arcs.shape
    if B == 0 or counts.dim() != 1 or counts.shape[0] % B:
        raise ValueError("sections: counts must be B * NBm block counts")
    lengths, base, ds32, NBm, _ = plain_encode.section_rows(arcs, counts, lengths, base32)
    if (base % 4).any():
        raise ValueError("sections: the archive offset must be 16-byte aligned")
    _check_symbols(pdfs, "sections weights")
    if pdfs.shape[0] != B:
        raise ValueError(f"sections weights: expected {B} rows, got {pdfs.shape[0]}")
    _build.check_cuda_tensor(counts, "sections counts", torch.int32, B * NBm)
    _build.check_cuda_tensor(states, "sections states", torch.int32, B * NBm * C.NUM_INTERLEAVED)
    if use_checksum:
        _build.check_cuda_tensor(checksums, "sections checksums", torch.int32, B, align=4)
    host = plain_encode.section_geometry(lengths, base, prob_bits, use_checksum, arcs.device)
    prefix = torch.empty((B, NBm), dtype=torch.int32, device=arcs.device)
    sizes = torch.empty(B, dtype=torch.int64, device=arcs.device)
    _build.launch(
        "sections", counts.data_ptr(), states.data_ptr(), pdfs.data_ptr(), host.data_ptr(),
        checksums.data_ptr() if use_checksum else None, B, NBm, arcs.data_ptr(), R,
        prefix.data_ptr(), sizes.data_ptr(),
    )
    return prefix, ds32.tolist(), host[8], sizes


def ans_encode_batched_into(
    arcs, base32, data32, lengths, prob_bits, pdfs, use_checksum=False,
    checksums=None, *, plain, lengths_t=None, batched=False, tables=None,
):
    """Encode the first lengths[m] bytes of row m of `data32` ((B, L/4)
    int32) with the quantized pdfs[m] ((B, 256); int32 on the card) into
    row m of `arcs` ((B, R) int32) at u32 offset `base32` (an int for every
    member or B host ints, each a multiple of 4), in place, for every
    member at once: one encode launch, one sections launch, one assembly
    launch. `tables` is the pdfs' (B, 512) encode tables if the caller has
    them (:func:`quantize`), else they are built here (one launch of the
    tables kernel on the card).

    `lengths` is B host ints (ragged allowed); `lengths_t` their (B,) int64
    copy on the device, if the caller has one (else
    :func:`layout.lengths_tensor`'s, when the lengths differ). `plain`
    selects the kernels' plain versions: the
    callers pass it for CPU tensors, and for the plain reference pipeline
    that the chip check runs on the card. Returns the archives' byte sizes,
    (B,) int64 on the device, with SIZE_OVERFLOW_BIT where a member's block
    overflowed. `batched` names the stages' ranges ``ans.encode_kernel``,
    ``ans.sections`` and ``ans.assembly`` or their ``_batched`` forms, as the
    JAX package names those of its single and batched entry points.
    """
    if prob_bits not in C.SUPPORTED_PROB_BITS:
        raise ValueError(f"prob_bits {prob_bits} not in {C.SUPPORTED_PROB_BITS}")
    if any(b % 4 for b in ([base32] if isinstance(base32, int) else base32)):
        raise ValueError("ans encode: the archive offset must be 16-byte aligned")
    # the kernels take one length (payload offset) when all members share it
    n = lengths[0]
    if any(m != n for m in lengths):
        n = lengths_t if lengths_t is not None else layout.lengths_tensor(lengths, data32.device)
    stage = "_batched" if batched else ""
    cuda = data32.is_cuda
    with annotate("ans.encode_kernel" + stage, cuda):
        if tables is None:
            tables = plain_encode.encode_table(pdfs) if plain else encode_table_cuda(pdfs)
        encode_fn = plain_encode.encode_blocks_batched if plain else encode_blocks_batched_cuda
        staged, counts, states = encode_fn(data32, n, prob_bits, tables)
    with annotate("ans.sections" + stage, cuda):
        sections_fn = (
            plain_encode.write_sections_batched if plain else write_sections_batched_cuda
        )
        prefix, ds32, ds32_t, sizes = sections_fn(
            arcs, base32, pdfs, states, counts, lengths, prob_bits, use_checksum, checksums,
        )
    with annotate("ans.assembly" + stage, cuda):
        assemble_fn = (
            plain_encode.assemble_payload_batched if plain else assemble_payload_batched_cuda
        )
        ds = ds32[0] if all(d == ds32[0] for d in ds32) else ds32_t
        assemble_fn(arcs, ds, staged, counts, prefix)
    return sizes


def ans_encode_padded(
    data, length, prob_bits=C.DEFAULT_PROB_BITS, use_checksum=False,
    precomputed_histogram=None, precomputed_pdf=None,
):
    """Compress data[:length] into a coalesced ANS archive.

    Counterpart of ``dietgpu_tpu.backend.ans_encode_padded``. `data` is
    (L,) uint8 or the same bytes packed as (L/4,) int32, with L a positive
    multiple of 4096. Returns (archive (A/4,) int32, size 0-dim int64) with
    A = encode.archive_buffer_bytes(L); archive bytes [0, size) are the
    archive, byte for byte the JAX package's, and bytes past size are
    unspecified. `precomputed_histogram` ((256,) counts of data[:length])
    or `precomputed_pdf` ((256,) weights summing to 2^prob_bits) skip the
    histogram pass.

    On the card the chain is the histogram kernel (with the checksum fused
    when `use_checksum`), the tables, encode, sections and assembly
    kernels, with no host round trip; on the CPU the same chain runs
    through the kernels' plain versions. It is
    :func:`ans_encode_batched` on a batch of one.
    """
    return _encode_one(data, length, prob_bits, use_checksum, precomputed_histogram,
                       precomputed_pdf, plain=not data.is_cuda)


def ans_encode_padded_plain(
    data, length, prob_bits=C.DEFAULT_PROB_BITS, use_checksum=False,
    precomputed_histogram=None, precomputed_pdf=None,
):
    """:func:`ans_encode_padded` through every kernel's plain version, on
    the device of `data`: the reference the chip check holds the kernel
    path against on the card."""
    return _encode_one(data, length, prob_bits, use_checksum, precomputed_histogram,
                       precomputed_pdf, plain=True)


def _encode_one(data, length, prob_bits, use_checksum, precomputed_histogram,
                precomputed_pdf, plain):
    if data.dim() != 1:
        raise ValueError("ans encode: data must be 1-D")
    if isinstance(length, torch.Tensor):
        length = int(host_read(length))
    elif not isinstance(length, int):
        length = int(length)
    pdfs = hist = None
    if precomputed_pdf is not None:
        pdfs = precomputed_pdf[None]
    elif precomputed_histogram is not None:
        hist = precomputed_histogram[None]
    arcs, sizes = _encode_batched(data[None], [length], pdfs, prob_bits, use_checksum,
                                  plain, hist=hist, batched=False)
    return arcs[0], sizes[0]


def ans_encode_batched(
    datas, length, pdfs=None, prob_bits=C.DEFAULT_PROB_BITS, use_checksum=False
):
    """Compress the first length[m] bytes of row m of `datas` into archive
    m, for B members with one launch of each kernel.

    Counterpart of ``dietgpu_tpu.ans.pallas_encode.ans_encode_batched_pallas``
    and, with ``pdfs=None``, of the JAX package's one-grid batch encode
    (``api._batch_ans_encode_onegrid``: per-member histograms, then
    ``normalize_probs``, then the batched encode). `datas` is (B, L) uint8
    or the same bytes packed as (B, L/4) int32, L a positive multiple of
    4096; `length` is an int (every member) or B ints, each in [0, L];
    `pdfs` is (B, 256) weights summing to 2^prob_bits per member, or None
    for each member's own quantized histogram (one launch of the histogram
    kernel for the batch, the checksum fused when `use_checksum`).

    Returns (archives (B, A/4) int32, sizes (B,) int64) with A =
    encode.archive_buffer_bytes(L), the port's own member stride: bytes
    [0, sizes[m]) of row m are member m's archive, byte for byte the JAX
    package's; SIZE_OVERFLOW_BIT marks a member whose block overflowed.
    Nothing is read back to the host, and the number of torch ops does not
    depend on B.
    """
    return _encode_batched(datas, length, pdfs, prob_bits, use_checksum,
                           plain=not datas.is_cuda, batched=True)


def ans_encode_batched_plain(
    datas, length, pdfs=None, prob_bits=C.DEFAULT_PROB_BITS, use_checksum=False
):
    """:func:`ans_encode_batched` through every kernel's plain version, on
    the device of `datas`: the reference the chip check holds the batched
    kernels against on the card."""
    return _encode_batched(datas, length, pdfs, prob_bits, use_checksum, plain=True,
                           batched=True)


def _encode_batched(datas, length, pdfs, prob_bits, use_checksum, plain, batched, hist=None):
    """`hist`, if given, is each member's (B, 256) histogram of its first
    length[m] bytes, in place of the histogram pass; `batched` as in
    :func:`ans_encode_batched_into`."""
    if datas.dim() != 2:
        raise ValueError("ans encode: a batch is (B, L) uint8 or (B, L/4) int32")
    data32 = datas.contiguous().view(torch.int32) if datas.dtype == torch.uint8 else datas
    if data32.dtype != torch.int32:
        raise ValueError(f"ans encode: unsupported batch dtype {datas.dtype}")
    B, n4 = data32.shape
    L = 4 * n4
    if B == 0 or L == 0 or L % C.DEFAULT_BLOCK_SIZE:
        raise ValueError(f"ans encode: {B} rows of {L} bytes, not a batch of 4096-byte blocks")
    lengths = layout.member_lengths(length, B, L, "ans encode")
    dev = data32.device
    lengths_t = None
    if not all(n == lengths[0] for n in lengths):
        lengths_t = layout.lengths_tensor(lengths, dev)
    cks = None
    if (pdfs is None and hist is None) or use_checksum:
        hist_fn = (
            cuda_hist.histogram_u8_batched_plain if plain
            else cuda_hist.histogram_u8_batched_cuda
        )
        with annotate("ans.hist", data32.is_cuda):
            h, cks = hist_fn(data32, lengths, use_checksum, lengths_t)
        hist = h if hist is None else hist
    tables = None
    if pdfs is None:
        totals = lengths[0] if lengths_t is None else lengths_t
        pdfs, tables = quantize(hist.to(dev), totals, prob_bits, plain)
    elif plain:
        pdfs = layout.to_u32(pdfs.to(dev))
    else:
        pdfs = pdfs.to(dev, torch.int32).contiguous()
    arcs = torch.empty(
        (B, plain_encode.archive_buffer_bytes(L) // 4), dtype=torch.int32, device=dev
    )
    sizes = ans_encode_batched_into(
        arcs, 0, data32, lengths, prob_bits, pdfs, use_checksum, cks, plain=plain,
        lengths_t=lengths_t, batched=batched, tables=tables,
    )
    return arcs, sizes
