"""Symbol statistics: histogram and exact probability quantization (torch).

Bit-exact twin of ``dietgpu_tpu.ans.stats`` (reference:
GpuANSStatistics.cuh:179-367), quirks included. u32 values are computed in
int64; every function works on the device of its inputs and runs as a short
fixed sequence of tensor ops (no host synchronisation and no copy from the
host, so a CUDA graph captures it). ``normalize_probs`` and
``build_encode_table`` are the CPU route and the plain version of the
tables kernel (``csrc/stats.cu``), which computes both on the card.
"""

import torch

from .. import constants as C
from . import layout


def histogram_u8(data: torch.Tensor, length: int) -> torch.Tensor:
    """256-bin histogram of data[:length] (1-D uint8) as int64."""
    assert data.dtype == torch.uint8
    return torch.bincount(data[: int(length)].long(), minlength=C.NUM_SYMBOLS)


def normalize_probs(hist: torch.Tensor, total, prob_bits: int) -> torch.Tensor:
    """Quantize histograms to weights summing to exactly 2^prob_bits.

    `hist` is (256,) or a batch (..., 256), one histogram per row; `total`
    is an int or a tensor of the batch shape, normally ``hist.sum(-1)``.
    Returns int64 of `hist`'s shape. The rows are independent, and the
    number of torch ops does not depend on the batch size.
    """
    K = 1 << prob_bits
    dev = hist.device
    hist = layout.to_u32(hist)
    if not isinstance(total, torch.Tensor):  # a fill, not a copy from the host
        total = torch.full(hist.shape[:-1], total, dtype=torch.int64, device=dev)
    total = layout.to_u32(total)[..., None]
    # a tensor divisor: a Python one would be multiplied by its reciprocal
    ratio = hist.to(torch.float32) / total.to(torch.float32)
    ratio = torch.where(total == 0, 0.0, ratio)
    # K is a power of two, so the product rounds as with a float32 K
    q = (ratio * float(K)).to(torch.int64)
    q = torch.where((hist > 0) & (q == 0), 1, q)

    diff = K - q.sum(-1, keepdim=True)
    sym = torch.arange(C.NUM_SYMBOLS, device=dev)

    # Deficit branch: +1 per symbol-value pass (GpuANSStatistics.cuh:258-273)
    dpos = diff.clamp(min=0)
    q_def = q + dpos // C.NUM_SYMBOLS + (sym < dpos % C.NUM_SYMBOLS).long()

    # Excess branch (GpuANSStatistics.cuh:274-315): repeatedly take 1 from
    # the smallest >1 weights, in the descending order of the unique key
    # (q<<16)|sym. The JAX twin runs the passes as a while loop; here they
    # are solved in closed form so no pass count is read back to the host.
    # With vals in rank order, a full pass takes 1 from every value > 1,
    # so after m full passes a value v > 1 is max(v - m, 1) and the passes
    # have taken C(m) = sum(min(m, max(v - 1, 0))). The loop makes the
    # largest m with C(m) <= need full passes, then one partial pass that
    # takes the remaining r from the last r ranks among the values still > 1.
    # m is searched over 0..K, exact whenever no weight exceeds K (every
    # caller passes total == hist.sum(), which bounds each weight by K).
    # C(m) is evaluated for every m at once, in (K) work per row, not
    # (K + 1) * 256: C(t) - C(t - 1) is the number of spares >= t, counted
    # by a search in the negated spares (ascending in rank order), so
    # C(1..K) is its cumulative sum; C(0) = 0 <= need always.
    # The keys are distinct, so one sort ranks them: vals0 is q in
    # descending key order, and rank (the inverse permutation) maps each
    # symbol to its place in it.
    key, order = torch.sort((q << 16) | sym, -1, descending=True)
    vals0 = key >> 16
    rank = torch.empty_like(order).scatter_(-1, order, sym.expand_as(order))
    need0 = (-diff).clamp(min=0)
    neg_spare = (1 - vals0).clamp(max=0)
    neg_t = torch.arange(-1, -K - 1, -1, device=dev).expand(*q.shape[:-1], K)
    steps = torch.searchsorted(neg_spare, neg_t.contiguous(), right=True)
    m = (torch.cumsum(steps, -1) <= need0).sum(-1, keepdim=True)
    vals = torch.where(vals0 > 1, (vals0 - m).clamp(min=1), vals0)
    r = need0 + torch.maximum(neg_spare, -m).sum(-1, keepdim=True)  # need - C(m)
    g = (vals > 1).sum(-1, keepdim=True)
    dec = (sym >= g - r) & (sym < g)
    vals = vals - dec.long()
    q_exc = torch.gather(vals, -1, rank)

    q = torch.where(diff > 0, q_def, torch.where(diff < 0, q_exc, q))
    return torch.where(total == 0, torch.zeros_like(q), q)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values < 2^32."""
    pw = torch.ones(32, dtype=torch.int64, device=x.device) << torch.arange(
        32, device=x.device
    )
    return (x[..., None] >= pw).sum(dim=-1)


def div_magic_u32(pdf: torch.Tensor):
    """(magic, shift) constant-division pairs as int64 u32 values.

    magic = floor(2^32 * (2^shift - pdf) / pdf) + 1 with
    shift = ceil(log2(pdf)); pdf 0 is treated as 1. Reference values:
    GpuANSStatistics.cuh:345-358.
    """
    p = layout.to_u32(pdf).clamp(min=1)
    shift = _bit_length(p - 1)
    a = (1 << shift) - p
    magic = (((a << 32) // p) + 1) & layout.U32_MASK
    return magic, shift


def umulhi_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of the u32 x u32 product (int64; no 64-bit overflow)."""
    a = layout.to_u32(a)
    b = layout.to_u32(b)
    return (a * (b >> 16) + ((a * (b & 0xFFFF)) >> 16)) >> 16


def build_encode_table(pdf: torch.Tensor):
    """Pack the encode lookup into two u32 arrays (int64), per row of a
    (..., 256) pdf.

    e1 = (shift << 24) | (pdf << 12) | cdf   (pdf, cdf <= 2^11; shift <= 11)
    e2 = magic
    """
    pdf = layout.to_u32(pdf)
    cdf = torch.cumsum(pdf, -1) - pdf
    magic, shift = div_magic_u32(pdf)
    e1 = ((shift << 24) | (pdf << 12) | cdf) & layout.U32_MASK
    return e1, magic
