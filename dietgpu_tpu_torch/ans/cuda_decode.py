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

The kernel parses the headers and builds the decode LUT on the device, so
the decode needs no host round trip; the plain versions do the same in
torch. A CUDA tensor goes through the kernel; a CPU tensor through the
plain version.
"""

import torch

from .. import _build
from .. import constants as C
from ..floatcodec import split
from . import checksum, layout
from . import decode as plain_decode

FLOAT_TYPES = (*split.HALF_TYPES, C.FLOAT_TYPE_FLOAT32)


def _check_archive(arc32, out_max, prob_bits):
    if prob_bits not in C.SUPPORTED_PROB_BITS:
        raise ValueError(f"prob_bits {prob_bits} not in {C.SUPPORTED_PROB_BITS}")
    if out_max <= 0 or out_max % C.DEFAULT_BLOCK_SIZE:
        raise ValueError(f"decode: capacity {out_max} is not a positive multiple of 4096")
    if arc32.dtype != torch.int32 or arc32.dim() != 1:
        raise ValueError("decode: the archive must be a 1-D int32 tensor")


def _check(arc32, float_type, out_max_words, prob_bits):
    if float_type not in FLOAT_TYPES:
        raise ValueError(f"decode: float type {float_type} is not f16/bf16/f32")
    _check_archive(arc32, out_max_words, prob_bits)
    if arc32.shape[0] < 4:
        raise ValueError("decode: a float container has at least 4 words")


def _section(arc32, off32, n32):
    """arc32[off32 : off32 + n32], zero-filled past the buffer's end."""
    s = arc32[off32 : off32 + n32]
    return torch.cat([s, s.new_zeros(n32 - s.shape[0])])


def _digest(out32, with_digest):
    if with_digest:
        return checksum._fold8(checksum.xor_reduce(out32))
    return torch.zeros((), dtype=torch.int64, device=out32.device)


def decode_float_plain(
    arc32, float_type, out_max_words, prob_bits, static_length=None, with_digest=False
):
    """Plain version of the decode kernel's float configurations.

    Returns (out32, success bool, size int64 (the header's word count),
    digest int64 (folded XOR of out32, or 0)), all 0-dim tensors but
    out32, on the archive's device. out32 is (Lw/2,) int32 word pairs for
    f16/bf16 and (Lw,) int32 words for f32, zero past the word count.
    """
    _check(arc32, float_type, out_max_words, prob_bits)
    Lw = out_max_words
    dev = arc32.device
    u = layout.to_u32(arc32)
    h = u[:4].tolist()
    n = layout.as_i32(h[1])
    ok = h[0] == (C.FLOAT_MAGIC << 16) | C.FLOAT_VERSION
    ok = ok and (h[2] & 0xF) == float_type and n <= Lw
    if static_length is not None:
        ok = ok and n == min(static_length, Lw)
    n_eff = min(max(n, 0), Lw)

    f32 = float_type == C.FLOAT_TYPE_FLOAT32
    hi_base = 4 + C.round_up(n_eff, 8) // 2
    base = hi_base + C.round_up(n_eff, 16) // 4 if f32 else 4 + C.round_up(n_eff, 16) // 4
    res = plain_decode.ans_decode_padded(arc32[base:], prob_bits, Lw)
    ok = ok and bool(res["success"]) and layout.as_i32(int(res["size"])) == n_eff

    if f32:
        lo = _section(arc32, 4, Lw // 2).view(torch.int16)
        hi = layout.u32_to_u8le(_section(arc32, hi_base, Lw // 4))
        words = split.join_words(res["out"], (lo, hi), float_type)
    else:
        nc = layout.u32_to_u8le(_section(arc32, 4, Lw // 4))
        words = split.join_words(res["out"], (nc,), float_type)
    valid = torch.arange(Lw, device=dev) < n_eff
    words = torch.where(valid, words, torch.zeros((), dtype=words.dtype, device=dev))
    out32 = words.view(torch.int32)
    return (
        out32,
        torch.tensor(ok, device=dev),
        torch.tensor(h[1], dtype=torch.int64, device=dev),
        _digest(out32, with_digest),
    )


def _status(status):
    st = layout.to_u32(status)
    return st[0] != 0, st[1], st[2]


def decode_float_cuda(
    arc32, float_type, out_max_words, prob_bits, static_length=None, with_digest=False
):
    """Launch ``csrc/decode.cu`` (f16/bf16 or f32 configuration); same
    contract as :func:`decode_float_plain`."""
    _check(arc32, float_type, out_max_words, prob_bits)
    _build.check_cuda_tensor(arc32, "decode archive", torch.int32, align=4)
    dev = arc32.device
    f32 = float_type == C.FLOAT_TYPE_FLOAT32
    out32 = torch.empty(
        out_max_words if f32 else out_max_words // 2, dtype=torch.int32, device=dev
    )
    status = torch.zeros(3, dtype=torch.int32, device=dev)
    nb_cap = out_max_words // C.DEFAULT_BLOCK_SIZE
    sl = -1 if static_length is None else static_length
    if f32:
        _build.launch(
            "decode_f32", arc32.data_ptr(), arc32.shape[0], out32.data_ptr(), nb_cap,
            prob_bits, sl, int(with_digest), status.data_ptr(),
        )
    else:
        _build.launch(
            "decode", arc32.data_ptr(), arc32.shape[0], out32.data_ptr(), nb_cap,
            float_type, prob_bits, sl, int(with_digest), status.data_ptr(),
        )
    return (out32, *_status(status))


def decode_float(
    arc32, float_type, out_max_words, prob_bits, static_length=None, with_digest=False
):
    fn = decode_float_cuda if arc32.is_cuda else decode_float_plain
    return fn(arc32, float_type, out_max_words, prob_bits, static_length, with_digest)


def decode_raw_plain(arc32, prob_bits, out_max, with_digest=False):
    """Plain version of the decode kernel's raw-byte configuration.

    Returns (out32 (out_max/4,) int32 packed bytes, zero past each block's
    symbols, success bool (magic, prob_bits, header byte count <=
    out_max), size int64 (the header's byte count), digest int64 (folded
    XOR of out32, or 0)), on the archive's device.
    """
    _check_archive(arc32, out_max, prob_bits)
    res = plain_decode.ans_decode_padded(arc32, prob_bits, out_max)
    out32 = layout.u8_to_u32le(res["out"])
    return out32, res["success"], res["size"], _digest(out32, with_digest)


def decode_raw_cuda(arc32, prob_bits, out_max, with_digest=False):
    """Launch ``csrc/decode.cu`` (raw-byte configuration); same contract as
    :func:`decode_raw_plain`."""
    _check_archive(arc32, out_max, prob_bits)
    _build.check_cuda_tensor(arc32, "decode archive", torch.int32, align=4)
    dev = arc32.device
    out32 = torch.empty(out_max // 4, dtype=torch.int32, device=dev)
    status = torch.zeros(3, dtype=torch.int32, device=dev)
    _build.launch(
        "decode_raw", arc32.data_ptr(), arc32.shape[0], out32.data_ptr(),
        out_max // C.DEFAULT_BLOCK_SIZE, prob_bits, int(with_digest), status.data_ptr(),
    )
    return (out32, *_status(status))


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
    fn = decode_raw_cuda if arc32.is_cuda else decode_raw_plain
    out32, success, size, digest = fn(arc32, prob_bits, out_max, verify_checksum)
    checksum_ok = torch.ones((), dtype=torch.bool, device=arc32.device)
    if verify_checksum and arc32.shape[0] >= 6:
        opts, stored = layout.to_u32(arc32[4:6]).unbind()
        checksum_ok = ((opts & 0x10) == 0) | (digest == stored)
    return {
        "out": layout.u32_to_u8le(out32),
        "size": size,
        "success": success,
        "checksum_ok": checksum_ok,
    }
