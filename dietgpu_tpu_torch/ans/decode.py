"""rANS decoder, plain torch.

Counterpart of ``dietgpu_tpu.ans.decode``: the same packed decode LUT and
the same reverse 128-step walk over (blocks, 32) states, with the same
status flags and the same clamps, so a lying header fails `success`
without indexing out of bounds. It is the plain version of the decode half
of ``csrc/decode.cu``. It reads the header on the host (it is the plain
version; the kernel reads it on the device). :func:`decode_rows` decodes a
batch of archives, each with its own table, in one pass (plain version of
the per-member-table decode); the single decoder is its one-row case.
"""

import numpy as np
import torch

from .. import constants as C
from ..profiling import host_read
from . import layout
from .checksum import checksum_rows

S = C.STEPS_PER_BLOCK
W = C.NUM_INTERLEAVED
MW = C.MAX_COMP_WORDS_PER_BLOCK


def decode_scratch_bytes(max_size: int, num_in_batch: int = 1) -> int:
    """Device scratch the reference reserves for a batch decode
    (GpuANSDecode.cuh:484-504: a 2^probBits u32 table per member, sized for
    probBits 11; :556-575: the two checksum vectors) at its 256-byte
    granularity (StackDeviceMemory.h:24): the API's `temp_mem` for
    decompress, as ``dietgpu_tpu.ans.decode`` reports it. `max_size` does
    not enter it, as in the JAX package."""

    def align(x):
        return C.round_up(x, 256)

    table_bytes = 4 * (1 << 11)
    total = align(num_in_batch * table_bytes)
    total += 2 * align(num_in_batch * 4)  # checksum + archive-checksum vecs
    return total


def build_decode_lut(pdf: torch.Tensor, prob_bits: int) -> torch.Tensor:
    """Packed decode LUT: (sminus << 20) | (pdf << 8) | sym, size
    2^prob_bits, int64 (reference TableT packing, GpuANSDecode.cuh:34-41);
    (B, 2^prob_bits) for a (B, 256) batch of pdfs."""
    K = 1 << prob_bits
    pdf = layout.to_u32(pdf)
    incl = torch.cumsum(pdf, -1)
    slots = torch.arange(K, device=pdf.device).expand(*pdf.shape[:-1], K).contiguous()
    sym = torch.searchsorted(incl, slots, right=True).clamp(max=C.NUM_SYMBOLS - 1)
    pdf_of = torch.gather(pdf, -1, sym)
    cdf_of = torch.gather(incl, -1, sym) - pdf_of
    sminus = (slots - cdf_of) & layout.U32_MASK
    return ((sminus << 20) | (pdf_of << 8) | sym) & layout.U32_MASK


def ans_decode_padded(arc32, prob_bits, out_max, verify_checksum=False):
    """Decode an archive held as (A/4,) int32 u32 words.

    Returns dict: out (out_max,) uint8 (bytes past size zero), size (u32
    word count from the header, int64), success (header ok, prob_bits
    match, capacity sufficient), checksum_ok (False only on a verified
    mismatch). All are tensors on the archive's device.
    """
    res = decode_rows(layout.to_u32(arc32)[None], prob_bits, out_max,
                      verify_checksum=verify_checksum)
    return {k: v[0] for k, v in res.items()}


def decode_rows(u, prob_bits, out_max, base=None, static_nb=None, verify_checksum=False):
    """Decode B archives at once, archive m at u32 offset base[m] (host
    ints, default 0) of row m of `u` ((B, A32) int64 u32 values); each row
    is decoded exactly as :func:`ans_decode_padded` decodes
    ``row[base[m]:]`` alone, clamps included. `static_nb` is the batched
    path's known block count: the geometry comes from it and success
    requires the header's count to equal it (as ``static_nb`` in
    ``ans_decode_batched_pallas``).

    Returns the dict of :func:`ans_decode_padded` with a leading (B,) dim.
    """
    assert out_max % C.DEFAULT_BLOCK_SIZE == 0 and out_max > 0
    dev = u.device
    B, A32 = u.shape
    NB = out_max // C.DEFAULT_BLOCK_SIZE
    K = 1 << prob_bits
    base = np.zeros(B, np.int64) if base is None else np.asarray(base, np.int64)
    rel_len = A32 - base
    if A32 == 0:
        u = u.new_zeros(B, 1)
    # a row shorter than 137 words reads as zero-padded to 137
    lim = np.maximum(rel_len, 137)
    base_t, rel_t, lim_t = (
        torch.from_numpy(x).to(dev)[:, None] for x in (base, rel_len, lim)
    )

    def take(rel):
        """Words at (B, k) indices relative to each archive, clamped to
        [0, lim - 1] and zero past the archive's end."""
        rel = torch.minimum(rel.clamp(min=0), lim_t - 1)
        v = torch.gather(u, 1, (rel + base_t).clamp(max=u.shape[1] - 1))
        return torch.where(rel < rel_t, v, 0)

    def cols(first, k):
        return (first + torch.arange(k, device=dev))[None, :].expand(B, k)

    h = host_read(take(cols(0, 8)), plain=True).tolist()
    nb = np.array([layout.as_i32(r[1]) for r in h], np.int64)
    n = np.array([layout.as_i32(r[2]) for r in h], np.int64)
    success = np.array(
        [r[0] == (C.ANS_MAGIC << 16) | C.ANS_VERSION and (r[4] & 0xF) == prob_bits
         for r in h]
    ) & (n <= out_max)
    has_checksum = np.array([(r[4] & 0x10) != 0 for r in h])
    nb_eff = np.clip(nb, 0, NB)
    nb_geo, nb_live = nb_eff, nb_eff
    if static_nb is not None:
        nb_geo = np.full(B, min(static_nb, NB), np.int64)
        success &= nb == nb_geo
        nb_live = np.minimum(nb_geo, nb_eff)
    geo_t, live_t = (torch.from_numpy(x).to(dev)[:, None] for x in (nb_geo, nb_live))

    pw = take(cols(8, 128))
    pdf = torch.stack([pw & 0xFFFF, pw >> 16], dim=2).reshape(B, C.NUM_SYMBOLS)
    lut = build_decode_lut(pdf, prob_bits)

    state = take(cols(136, NB * W)).reshape(B * NB, W)

    bidx = torch.arange(NB, device=dev)[None, :]
    bw_start = 136 + geo_t * W
    live = bidx < live_t
    bw_x = torch.where(live, take(bw_start + 2 * bidx), 0).reshape(B * NB)
    bw_y = torch.where(live, take(bw_start + 2 * bidx + 1), 0)
    uncomp = bw_x >> 16
    pos = bw_x & 0xFFFF
    starts = torch.where(bw_y >= 1 << 31, bw_y - (1 << 32), bw_y)
    data_start = bw_start + 2 * (geo_t + (geo_t & 1))

    # per-block streams, (B * NB, MW) u16 values
    cols32 = torch.arange(MW // 2, device=dev)
    sidx = data_start[:, :, None] + (starts[:, :, None] + 2 * cols32) // 2
    s32 = take(sidx.reshape(B, NB * MW // 2)).reshape(B * NB, MW // 2)
    streams = torch.stack([s32 & 0xFFFF, s32 >> 16], dim=2).reshape(B * NB, MW)

    steps = (uncomp + W - 1) // W
    remainder = uncomp % W
    lanes = torch.arange(W, device=dev)
    out = torch.zeros((B * NB, S, W), dtype=torch.uint8, device=dev)
    for k in reversed(range(S)):
        active = k < steps
        is_tail = active & (k == steps - 1) & (remainder > 0)
        lane_limit = torch.where(is_tail, remainder, W)
        act = active[:, None] & (lanes[None, :] < lane_limit[:, None])

        slot = (state & (K - 1)).reshape(B, NB * W)
        t = torch.gather(lut, 1, slot).reshape(B * NB, W)
        new_state = ((t >> 8) & 0xFFF) * (state >> prob_bits) + (t >> 20)
        state = torch.where(act, new_state & layout.U32_MASK, state)

        read = act & (state < C.ANS_MIN_STATE)
        rank = torch.cumsum(read.flip(1).long(), dim=1).flip(1)
        ridx = (pos[:, None] - rank).clamp(0, MW - 1)
        v = torch.gather(streams, 1, ridx)
        state = torch.where(read, ((state << 16) + v) & layout.U32_MASK, state)
        pos = pos - read.sum(dim=1)
        out[:, k] = torch.where(act, t & 0xFF, 0).to(torch.uint8)

    out = out.reshape(B, out_max)
    checksum_ok = np.ones(B, bool)
    if verify_checksum and has_checksum.any():
        got = checksum_rows(out, np.clip(n, 0, out_max).tolist())
        got = host_read(got, plain=True).tolist()
        checksum_ok = ~has_checksum | (np.array(got) == np.array([r[5] for r in h]))
    return {
        "out": out,
        "size": torch.tensor([r[2] for r in h], dtype=torch.int64, device=dev),
        "success": torch.from_numpy(success).to(dev),
        "checksum_ok": torch.from_numpy(checksum_ok).to(dev),
    }
