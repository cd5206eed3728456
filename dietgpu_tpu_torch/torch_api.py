"""The ten ops with the reference's tensor contract, on the card or the CPU.

Counterpart of ``dietgpu_tpu.torch_api``, the drop-in analogue of the
reference's ``torch.ops.dietgpu.*`` custom ops (DietGpu.cpp:915-972): the
same ten operations on ``torch.Tensor``s, as a thin layer over the port's
:mod:`.api`. Where the JAX package's front-end copies host tensors into
JAX through numpy, this one takes the tensors where they are: on the card
every tensor stays on the card and goes through the CUDA kernels, on the
CPU through their plain versions.

Contract, as in ``dietgpu_tpu.torch_api``:
  * no CUDA stream or temp-memory tensor arguments: the allocator owns
    scratch, and the reported ``temp_mem_used`` is the reference's
    accounting;
  * ``decompress_data[_split_size]`` write into ``ts_out`` / ``t_out`` in
    place and return (status, sizes, temp_mem_used) in place of
    out-parameter tensors: ``decompress_data`` writes each member whose
    status is 1, ``decompress_data_split_size`` all of ``t_out`` only
    when every status is 1;
  * ``max_*_compressed_output_size`` return (size, B), the reverse of
    :mod:`.api`'s (B, size).

``decompress_data`` decodes each member straight into its ``ts_out``
tensor, with no staging copy and no host read, where the call allows it
(:func:`decodes_in_place`); otherwise it decodes into a buffer, reads the
status back and copies each member whose status is 1 out of it.

Each compress op runs inside the span ``front.compress`` and each
decompress op inside ``front.decompress`` (``profiling``), the :mod:`.api`
entry it calls nested in it as a child; host reads go through
``profiling.host_read``.
"""

from typing import Sequence

import torch

from . import api
from . import constants as C
from .ans import cuda_decode
from .profiling import entry, host_read


def _ints(split_sizes):
    if isinstance(split_sizes, torch.Tensor):
        return host_read(split_sizes).tolist()
    return split_sizes


# ---------------------------------------------------------------------------
# size queries (DietGpu.cpp max_* ops)
# ---------------------------------------------------------------------------


def max_any_compressed_size(nbytes: int) -> int:
    return api.max_any_compressed_size(nbytes)


def max_float_compressed_size(dtype: torch.dtype, size: int) -> int:
    return api.max_float_compressed_size(dtype, size)


def max_any_compressed_output_size(ts: Sequence[torch.Tensor]):
    B, size = api.max_any_compressed_output_size(ts)
    return size, B


def max_float_compressed_output_size(ts: Sequence[torch.Tensor]):
    B, size = api.max_float_compressed_output_size(ts)
    return size, B


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
    """Compress a batch. Returns (comp uint8 (B, bufsize), sizes int32 (B,),
    temp_mem_used int); row b's archive is comp[b, :sizes[b]]
    (DietGpu.cpp:149-308)."""
    return api.compress_data(compress_as_float, ts_in, checksum, prob_bits)


@entry("front.compress")
def compress_data_split_size(
    compress_as_float: bool,
    t_in: torch.Tensor,
    split_sizes: Sequence[int] | torch.Tensor,
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Compress consecutive splits of one flat tensor (DietGpu.cpp:310-460).
    Interior split starts must be 4-byte aligned."""
    return api.compress_data_split_size(
        compress_as_float, t_in, _ints(split_sizes), checksum, prob_bits
    )


@entry("front.compress")
def compress_data_simple(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Convenience tier: exact-size archive tensors (DietGpu.cpp:462-522)."""
    return api.compress_data_simple(compress_as_float, ts_in, checksum, prob_bits)


# ---------------------------------------------------------------------------
# decompress
# ---------------------------------------------------------------------------


def _overlap(spans) -> bool:
    """Whether a destination's bytes meet an archive's or another
    destination's (archives may share bytes with each other); `spans` are
    (start, end, is_destination)."""
    end_dest = end_arc = 0  # the furthest end of the destinations, of the archives so far
    for start, end, is_dest in sorted(spans):
        if start < end_dest or (is_dest and start < end_arc):
            return True
        if is_dest:
            end_dest = max(end_dest, end)
        else:
            end_arc = max(end_arc, end)
    return False


def decodes_in_place(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    ts_out: Sequence[torch.Tensor],
    checksum: bool,
) -> bool:
    """Whether :func:`decompress_data` decodes each member straight into
    ts_out: no checksum is verified (a mismatch must raise with ts_out as
    it was); every destination holds float words of ts_out[0]'s size (or
    bytes); the decode's descriptor form takes the archives and
    destinations where they lie (``cuda_decode.takes_members``: contiguous,
    aligned, whole u32 words and whole symbols, under 2^32 of them); and no
    destination overlaps an archive or another destination. Anything else
    is decoded into a buffer and copied out."""
    if checksum or not ts_in or len(ts_in) != len(ts_out):
        return False
    sym = ts_out[0].element_size() if compress_as_float else 1
    if compress_as_float and any(t.element_size() != sym for t in ts_out):
        return False
    if not cuda_decode.takes_members(ts_in, ts_out, sym):
        return False
    spans = [(t.data_ptr(), t.data_ptr() + t.nbytes, is_dest)
             for ts, is_dest in ((ts_out, True), (ts_in, False)) for t in ts if t.nbytes]
    return not _overlap(spans)


def _write_ok(dsts, srcs, status) -> None:
    """Copy each decoded member (in its integer dtype) into its destination
    where status is 1, in one fused copy. The members' bit views are made
    before the status read, while the card still decodes."""
    dsts, srcs = [api.as_bits(d) for d in dsts], [api.as_bits(s) for s in srcs]
    keep = [m for m, ok in enumerate(host_read(status).tolist()) if ok]
    api.copy_bits_([dsts[m] for m in keep], [srcs[m] for m in keep])


@entry("front.decompress")
def decompress_data(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    ts_out: Sequence[torch.Tensor],
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Decompress archives INTO ts_out (in place). Returns (status uint8
    (B,), sizes int32 (B,), temp_mem_used). status[b] = 0 with the required
    byte count in sizes[b] when ts_out[b] is too small, and ts_out[b] is
    then left as it was; a checksum mismatch raises (DietGpu.cpp:530-677).
    Where :func:`decodes_in_place` holds, the decode writes ts_out itself
    and nothing is read back; else it decodes into a buffer, reads the
    status and copies each member whose status is 1 out."""
    if decodes_in_place(compress_as_float, ts_in, ts_out, checksum):
        return api.decompress_into(compress_as_float, ts_in, ts_out, prob_bits)
    outs, status, sizes, tm = api._decompress_checked(
        compress_as_float, ts_in, ts_out, checksum, prob_bits, bits=True
    )
    _write_ok(ts_out, outs, status)
    return status, sizes, tm


@entry("front.decompress")
def decompress_data_split_size(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    t_out: torch.Tensor,
    split_sizes: Sequence[int] | torch.Tensor,
    checksum: bool = False,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Decompress a batch into consecutive splits of t_out (in place),
    written only when every member's status is 1: where one fails, all of
    t_out keeps its bytes (DietGpu.cpp:679-819). Returns (status, sizes,
    temp_mem_used). A t_out that is not contiguous is decoded into one
    scratch buffer and copied into once."""
    in_place = t_out.is_contiguous()
    flat = t_out.view(-1) if in_place else torch.empty(
        t_out.numel(), dtype=t_out.dtype, device=t_out.device)
    pieces = api._split_pieces(flat, _ints(split_sizes), "output")
    outs, status, sizes, tm = api._decompress_checked(
        compress_as_float, ts_in, pieces, checksum, prob_bits, bits=True
    )
    if bool(host_read(status.all())):
        api.copy_bits_(pieces, outs)
        if not in_place:
            api.copy_bits_([t_out], [flat.view(t_out.shape)])
    return status, sizes, tm


@entry("front.decompress")
def decompress_data_simple(
    compress_as_float: bool,
    ts_in: Sequence[torch.Tensor],
    checksum: bool = False,
):
    """Size-discovery tier: allocates exact outputs from the archive headers
    and decompresses (DietGpu.cpp:821-911)."""
    return api.decompress_data_simple(compress_as_float, ts_in, checksum)
