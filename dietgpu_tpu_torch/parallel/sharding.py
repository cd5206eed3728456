"""Sharded raw-ANS compression over a process group.

Counterpart of ``dietgpu_tpu.parallel.sharding``. In JAX one program runs
the codec on every device's shard under shard_map; here each rank calls
:func:`shard_compress` on its own shard, and a group rank stands in for
the mesh index. With `shared_stats` the ranks' histograms are summed with
one all-reduce, so every shard of one logical tensor is encoded with one
probability table (the "broadcast prob tables" collective mode). Tensors
on the card go through the histogram, tables, encode, sections, assembly
and decode kernels, CPU tensors through their plain versions.
"""

import torch
import torch.distributed as dist

from .. import constants as C
from ..ans.cuda_decode import ans_decode_padded
from ..ans.cuda_encode import ans_encode_padded, quantize
from ..ans.cuda_hist import histogram_u8
from .runtime import check_device, resolve_group


def make_group(ranks=None):
    """The process group over `ranks` (global ranks), or the default group
    for None. Like ``dist.new_group``, every rank of the default group
    must call it, members or not. Group ranks follow the sorted global
    ranks."""
    if ranks is None:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def shard_compress(
    data: torch.Tensor,
    length: int,
    group=None,
    prob_bits: int = C.DEFAULT_PROB_BITS,
    shared_stats: bool = False,
):
    """Compress this rank's shard: data[:length] of an (L,) uint8 tensor, L
    a positive multiple of 4096.

    Returns (archive (A/4,) int32, size 0-dim int64) as
    :func:`ans_encode_padded` does; bytes [0, size) equal the row of this
    rank in ``dietgpu_tpu.parallel.shard_compress``. With `shared_stats`
    every rank of `group` must call it: one all-reduce sums the
    histograms and the lengths, and every shard is encoded with the
    normalized sum.
    """
    group = resolve_group(group)
    check_device(data, group, "shard_compress")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError("shard_compress: data must be a 1-D uint8 tensor")
    length = int(length)
    if not shared_stats:
        return ans_encode_padded(data, length, prob_bits)
    # one all-reduce: the 256 counts and the length side by side
    counts = torch.cat([
        histogram_u8(data, length).to(torch.int64),
        torch.full((1,), length, dtype=torch.int64, device=data.device),
    ])
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    pdfs, _ = quantize(counts[None, : C.NUM_SYMBOLS], counts[C.NUM_SYMBOLS:], prob_bits,
                       plain=not data.is_cuda)
    return ans_encode_padded(data, length, prob_bits, precomputed_pdf=pdfs[0])


def shard_decompress(
    archive: torch.Tensor,
    capacity,
    out_len: int,
    group=None,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Decompress this rank's archive into (out_len,) bytes, out_len a
    positive multiple of 4096.

    Returns (out (out_len,) uint8, size 0-dim int64, ok 0-dim bool): ok is
    the decode's success and size <= `capacity`, as
    ``dietgpu_tpu.parallel.shard_decompress`` computes it. Nothing crosses
    the group; it checks only that the archive's device suits it.
    """
    group = resolve_group(group)
    check_device(archive, group, "shard_decompress")
    r = ans_decode_padded(archive, prob_bits, out_len)
    return r["out"], r["size"], r["success"] & (r["size"] <= capacity)
