"""rANS encode on the card: the encode kernel (``csrc/encode.cu``), the
section prefill, and the assembly kernel (``csrc/assembly.cu``), and the
raw-ANS entry point that puts the histogram kernel (``csrc/hist.cu``) in
front of them.

Counterpart of ``dietgpu_tpu.ans.pallas_encode`` (``_encode_stage1``,
``_encode_stage2``, ``_encode_finish``, ``ans_encode_padded_pallas``). A
CUDA tensor goes through the kernels; a CPU tensor through their plain
versions in :mod:`.encode` and :mod:`.cuda_hist`. The glue between them
(probability quantization, tables, sections, prefix) is torch on either
device.
"""

import torch

from .. import _build
from .. import constants as C
from . import cuda_hist
from . import encode as plain_encode
from . import layout, stats


def encode_blocks_cuda(data32, length, prob_bits, table):
    """Launch ``csrc/encode.cu``; same contract as :func:`encode.encode_blocks`
    except that staging words past a block's count are left unwritten."""
    NB = data32.shape[0] * 4 // C.DEFAULT_BLOCK_SIZE
    _build.check_cuda_tensor(data32, "encode data", torch.int32, NB * 1024)
    _build.check_cuda_tensor(table, "encode table", torch.int32, 512, align=4)
    dev = data32.device
    staged = torch.empty((NB, plain_encode.MW), dtype=torch.int16, device=dev)
    counts = torch.empty(NB, dtype=torch.int32, device=dev)
    states = torch.empty((NB, C.NUM_INTERLEAVED), dtype=torch.int32, device=dev)
    _build.launch(
        "encode", data32.data_ptr(), NB, length, prob_bits, table.data_ptr(),
        staged.data_ptr(), counts.data_ptr(), states.data_ptr(),
    )
    return staged, counts, states


def assemble_payload_cuda(arc32, ds32, staged, counts, prefix):
    """Launch ``csrc/assembly.cu``; same contract as
    :func:`encode.assemble_payload`."""
    nb = prefix.shape[0]
    if nb == 0:
        return
    if ds32 % 4:
        raise ValueError("assembly: payload offset must be 16-byte aligned")
    _build.check_cuda_tensor(arc32, "assembly archive", torch.int32)
    _build.check_cuda_tensor(staged, "assembly staged", torch.int16)
    _build.check_cuda_tensor(counts, "assembly counts", torch.int32, align=4)
    _build.check_cuda_tensor(prefix, "assembly prefix", torch.int32, nb, align=4)
    if staged.shape[0] < nb or counts.shape[0] < nb:
        raise ValueError("assembly: fewer staged blocks than prefix entries")
    cap_vec = max(0, (arc32.shape[0] - ds32) // 4)
    _build.launch(
        "assembly", staged.data_ptr(), counts.data_ptr(), prefix.data_ptr(),
        nb, arc32.data_ptr() + 4 * ds32, cap_vec,
    )


def ans_encode_into(
    arc32, base32, data32, length, prob_bits, pdf, use_checksum=False,
    checksum=None, *, plain,
):
    """Encode data32's first `length` bytes with the quantized `pdf` into
    the archive at u32 offset `base32` of `arc32` (in place).

    `plain` selects the encode and assembly kernels' plain versions; the
    callers pass it for CPU tensors, and for the plain reference pipeline
    that the chip check runs on the card. Returns the archive's byte size
    as a 0-dim int64 tensor on the device, with SIZE_OVERFLOW_BIT set when
    a block overflowed.
    """
    if prob_bits not in C.SUPPORTED_PROB_BITS:
        raise ValueError(f"prob_bits {prob_bits} not in {C.SUPPORTED_PROB_BITS}")
    table = plain_encode.encode_table(pdf)
    encode_fn = plain_encode.encode_blocks if plain else encode_blocks_cuda
    staged, counts, states = encode_fn(data32, length, prob_bits, table)
    prefix, ds32, size = plain_encode.write_sections(
        arc32, base32, pdf, states, counts, length, prob_bits,
        use_checksum=use_checksum, checksum=checksum,
    )
    assemble_fn = plain_encode.assemble_payload if plain else assemble_payload_cuda
    assemble_fn(arc32, ds32, staged, counts, prefix)
    return size


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
    when `use_checksum`), ``normalize_probs``, the encode kernel, the
    sections and the assembly kernel, with no host round trip; on the CPU
    the same chain runs through the kernels' plain versions.
    """
    return _encode(
        data, length, prob_bits, use_checksum, precomputed_histogram, precomputed_pdf,
        plain=not data.is_cuda,
    )


def ans_encode_padded_plain(
    data, length, prob_bits=C.DEFAULT_PROB_BITS, use_checksum=False,
    precomputed_histogram=None, precomputed_pdf=None,
):
    """:func:`ans_encode_padded` through every kernel's plain version, on
    the device of `data`: the reference the chip check holds the kernel
    path against on the card."""
    return _encode(
        data, length, prob_bits, use_checksum, precomputed_histogram, precomputed_pdf,
        plain=True,
    )


def _encode(data, length, prob_bits, use_checksum, precomputed_histogram,
            precomputed_pdf, plain):
    data32 = layout.u8_to_u32le(data) if data.dtype == torch.uint8 else data
    L = data32.shape[0] * 4
    if L == 0 or L % C.DEFAULT_BLOCK_SIZE:
        raise ValueError(f"ans encode: {L} bytes is not a positive multiple of 4096")
    if not 0 <= length <= L:
        raise ValueError(f"ans encode: length {length} outside [0, {L}]")
    dev = data32.device
    hist = cks = None
    if (precomputed_pdf is None and precomputed_histogram is None) or use_checksum:
        hist_fn = cuda_hist.histogram_u8_plain if plain else cuda_hist.histogram_u8_cuda
        hist, cks = hist_fn(data32, length, with_checksum=use_checksum)
    if precomputed_pdf is not None:
        pdf = layout.to_u32(precomputed_pdf.to(dev))
    else:
        if precomputed_histogram is not None:
            hist = precomputed_histogram.to(dev)
        pdf = stats.normalize_probs(hist, length, prob_bits)
    arc32 = torch.empty(
        plain_encode.archive_buffer_bytes(L) // 4, dtype=torch.int32, device=dev
    )
    size = ans_encode_into(
        arc32, 0, data32, length, prob_bits, pdf, use_checksum, cks, plain=plain
    )
    return arc32, size
