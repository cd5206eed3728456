"""Compressed collectives on torch.distributed: codec time for wire bytes.

Counterpart of ``dietgpu_tpu.parallel.collectives``. Before an all-gather,
all-to-all or point-to-point exchange of f16/bf16/f32 shards, each rank
float-compresses what it sends; only the compressed payload crosses the
wire, and receivers decompress. Tensors on the card go through NCCL and
the port's kernels, CPU tensors through gloo and the kernels' plain
versions. Every archive a rank sends is byte for byte the JAX package's
for the same shard, and every output equals the JAX collective's row for
that rank.

Each function is called by every rank of `group` with its own shard, as a
torch.distributed collective is. Two exchange strategies, as in JAX:

  * fixed budget (`compressed_all_gather`, `_all_to_all`, `_ppermute`,
    `_reduce_scatter`, `_all_reduce`): a per-shard byte budget (default
    0.75x raw). The ranks vote with one all-reduce of an "all fit" flag,
    read once on the host so that every rank takes the same branch; if
    any archive overflows, the whole collective moves the raw bytes.
  * two-phase (`compressed_all_gather_auto`): compress once, all-reduce
    the largest size, and move exactly that many bytes (bucketed to 1/16
    of raw), so the wire tracks the data's real ratio.

A payload is the first round_up(budget, 4) / 4 int32 words of the rank's
archive, zero-padded past the archive buffer. Receivers decode all the
payloads they got with one batched decode. The raw path moves the words
as bytes (gloo has no int16).

Each collective's stages run inside the spans ``collective.compress``,
``.vote``, ``.exchange`` and ``.decode`` (``profiling``), whose call id is
the call's number on its group: the n-th collective call on a group has the
same id on every rank, so the spans of one call line up across ranks.
"""

import torch
import torch.distributed as dist

from .. import constants as C
from ..floatcodec import codec
from ..profiling import annotate, host_read
from .runtime import check_device, resolve_group

_TYPES = {
    torch.float16: C.FLOAT_TYPE_FLOAT16,
    torch.bfloat16: C.FLOAT_TYPE_BFLOAT16,
    torch.float32: C.FLOAT_TYPE_FLOAT32,
}
# all_gather_single replaces all_gather_into_tensor in newer torch
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_calls = {}  # group name -> collective calls made on it


def _call_id(group) -> str:
    """This collective call's id: ``<group name>.<n>`` for the n-th call on
    `group`, counted from 0 whether or not anything records."""
    name = group.group_name
    n = _calls.get(name, 0)
    _calls[name] = n + 1
    return f"{name}.{n}"


def _stage(name, x, call):
    """The span of collective stage `name` of call `call` on `x`'s device."""
    return annotate("collective." + name, x.is_cuda, call)


def default_budget_bytes(shard_words: int, word_size: int) -> int:
    """Default per-shard exchange budget: 0.75x raw, 16-byte aligned."""
    return C.round_up(int(shard_words * word_size * 0.75) + 4096, 16)


def _check(x, group, what, dims):
    check_device(x, group, what)
    if x.dtype not in _TYPES:
        raise ValueError(f"{what}: dtype {x.dtype} is not f16/bf16/f32")
    if x.dim() != dims or x.shape[-1] == 0:
        raise ValueError(f"{what}: expected a {dims}-D shard with words")


def _words(x):
    """Rows of x ((B, n) floats) as (B, Lw) codec words, Lw = round_up(n,
    4096): a view when n == Lw, else zero-padded."""
    B, n = x.shape
    w = x.contiguous().view(torch.int32 if x.dtype == torch.float32 else torch.int16)
    Lw = C.round_up(n, C.DEFAULT_BLOCK_SIZE)
    if n == Lw:
        return w
    padded = w.new_zeros((B, Lw))
    padded[:, :n] = w
    return padded


def _compress(x, prob_bits):
    """Float-compress each row of x ((B, n)) with one launch of each
    kernel. Returns (archives (B, F/4) int32, sizes (B,) int64)."""
    return codec.float_compress_batched(_words(x), x.shape[1], _TYPES[x.dtype], prob_bits)


def _payload(arcs, budget):
    """The first round_up(budget, 4) / 4 words of each archive row,
    contiguous, zero-padded past the row."""
    bunits = C.round_up(budget, 4) // 4
    if bunits > arcs.shape[1]:
        return torch.nn.functional.pad(arcs, (0, bunits - arcs.shape[1]))
    return arcs[:, :bunits].contiguous()


def _decode(rows, dtype, n, prob_bits):
    """Decode payload rows ((B, bunits) int32) with one launch into (B, n)
    floats."""
    Lw = C.round_up(n, C.DEFAULT_BLOCK_SIZE)
    r = codec.float_decompress_batched(rows, _TYPES[dtype], Lw, prob_bits, static_length=n)
    wd = torch.int32 if dtype == torch.float32 else torch.int16
    return r["out32"].view(wd)[:, :n].view(dtype)


def _vote(fits, group) -> bool:
    """True when `fits` holds on every rank: one all-reduce of a flag on the
    group's device, and one host read of it."""
    flag = fits.all().to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(host_read(flag))


def _all_gather(t, group):
    """(world, *t.shape): row r is rank r's `t`."""
    out = t.new_empty((dist.get_world_size(group) * t.numel(),))
    _ALL_GATHER(out, t.reshape(-1), group=group)
    return out.view(-1, *t.shape)


def _all_to_all(t, group):
    """Row d of `t` ((world, ...)) goes to rank d; row s of the result came
    from rank s."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _as_bytes(x):
    return x.contiguous().view(torch.uint8)


def compressed_all_gather(
    x: torch.Tensor, group=None, budget_bytes: int | None = None,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """All-gather this rank's shard x ((shard_words,) f16/bf16/f32) over
    `group` with on-the-fly float compression.

    Returns (full (world * shard_words,) x.dtype, rank r's shard at r *
    shard_words; used_compression bool, False on every rank when any
    rank's archive exceeded `budget_bytes`, and the raw words moved).
    """
    group = resolve_group(group)
    _check(x, group, "compressed_all_gather", 1)
    n = x.shape[0]
    if budget_bytes is None:
        budget_bytes = default_budget_bytes(n, x.element_size())
    call = _call_id(group)
    with _stage("compress", x, call):
        arcs, sizes = _compress(x[None], prob_bits)
    with _stage("vote", x, call):
        used = _vote(sizes <= budget_bytes, group)
    with _stage("exchange", x, call):
        if not used:
            return _all_gather(_as_bytes(x), group).view(x.dtype).reshape(-1), False
        rows = _all_gather(_payload(arcs, budget_bytes)[0], group)
    with _stage("decode", x, call):
        return _decode(rows, x.dtype, n, prob_bits).reshape(-1), True


def compressed_all_gather_auto(
    x: torch.Tensor, group=None, prob_bits: int = C.DEFAULT_PROB_BITS
):
    """Two-phase compressed all-gather: compress once, all-reduce the
    largest archive size (one int64 a rank, one host read), then all-gather
    exactly that many bytes, bucketed to 1/16 of raw, from each archive.
    Never falls back to raw: the budget comes from the data.

    Returns (full (world * shard_words,) x.dtype, wire bytes per shard int,
    the JAX package's `wire`). Raises OverflowError when a rank's archive
    overflowed a block's payload bound.
    """
    group = resolve_group(group)
    _check(x, group, "compressed_all_gather_auto", 1)
    n = x.shape[0]
    call = _call_id(group)
    with _stage("compress", x, call):
        arcs, sizes = _compress(x[None], prob_bits)
    with _stage("vote", x, call):  # the ranks agree on the largest size
        largest = sizes.clone()
        dist.all_reduce(largest, op=dist.ReduceOp.MAX, group=group)
        max_size = int(host_read(largest))
    if max_size & C.SIZE_OVERFLOW_BIT:
        raise OverflowError("compressed_all_gather_auto: a block overflowed its payload bound")
    bucket = max(C.round_up(n * x.element_size() // 16, 16), 4096)
    budget = C.round_up(max_size, bucket)
    with _stage("exchange", x, call):
        rows = _all_gather(_payload(arcs, budget)[0], group)
    with _stage("decode", x, call):
        return _decode(rows, x.dtype, n, prob_bits).reshape(-1), budget


def _chunk_exchange(x, group, budget, prob_bits):
    """Shared body of the all-to-all-shaped collectives: compress the rows
    of x ((world, chunk_words)) in one batched call, vote on the budget,
    send row d to rank d (compressed, or raw when any archive overflows)
    and decode what came in with one launch. Returns ((world, chunk_words)
    x.dtype, row s from rank s; used_compression bool)."""
    n = x.shape[1]
    call = _call_id(group)
    with _stage("compress", x, call):
        arcs, sizes = _compress(x, prob_bits)
    with _stage("vote", x, call):
        used = _vote(sizes <= budget, group)
    with _stage("exchange", x, call):
        if not used:
            return _all_to_all(_as_bytes(x), group).view(x.dtype), False
        recv = _all_to_all(_payload(arcs, budget), group)
    with _stage("decode", x, call):
        return _decode(recv, x.dtype, n, prob_bits), True


def compressed_all_to_all(
    x: torch.Tensor, group=None, budget_bytes: int | None = None,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """All-to-all of x ((world, chunk_words)): row d goes to rank d.

    Returns ((world, chunk_words) x.dtype, row s the chunk rank s sent
    here; used_compression bool). All `world` chunks are compressed in
    one batched call and decoded in one, so each kernel launches once.
    """
    group = resolve_group(group)
    _check(x, group, "compressed_all_to_all", 2)
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError("compressed_all_to_all: x needs one row per rank of the group")
    if budget_bytes is None:
        budget_bytes = default_budget_bytes(x.shape[1], x.element_size())
    return _chunk_exchange(x, group, budget_bytes, prob_bits)


def _edges(perm, world, rank):
    """(source, destination) of this rank in `perm`, each None without an
    edge; raises ValueError unless every rank is at most once a source and
    once a destination."""
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError("compressed_ppermute: a rank is twice a source or a destination")
    if not all(0 <= r < world for r in srcs + dsts):
        raise ValueError(f"compressed_ppermute: a rank outside [0, {world})")
    src = next((s for s, d in perm if d == rank), None)
    dst = next((d for s, d in perm if s == rank), None)
    return src, dst


def _permute(send, src, dst, rank, group):
    """Send `send` to group rank `dst` and receive a tensor like it from
    `src` (None for no edge); a self-edge is a local copy. Returns what
    came in, or None."""
    recv = None if src is None else torch.empty_like(send)
    if src == rank:
        recv.copy_(send)
    ops = []
    if dst is not None and dst != rank:
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group))
    if src is not None and src != rank:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def compressed_ppermute(
    x: torch.Tensor, perm=None, group=None, budget_bytes: int | None = None,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Point-to-point exchange of this rank's shard x ((shard_words,)) with
    on-the-fly float compression: the pipeline-parallel / halo-exchange
    member of the family.

    `perm` is (source, destination) pairs of group ranks, each rank at
    most once a source and once a destination (ValueError otherwise);
    default the +1 ring. Every rank compresses and votes, senders or not.
    Returns (what this rank received, (shard_words,) x.dtype, zeros when
    no edge targets it; used_compression bool, False everywhere when any
    rank's archive exceeded the budget).
    """
    group = resolve_group(group)
    _check(x, group, "compressed_ppermute", 1)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if perm is None:
        perm = [(s, (s + 1) % world) for s in range(world)]
    src, dst = _edges(perm, world, rank)
    n = x.shape[0]
    if budget_bytes is None:
        budget_bytes = default_budget_bytes(n, x.element_size())
    call = _call_id(group)
    with _stage("compress", x, call):
        arcs, sizes = _compress(x[None], prob_bits)
    with _stage("vote", x, call):
        used = _vote(sizes <= budget_bytes, group)
    with _stage("exchange", x, call):
        send = _payload(arcs, budget_bytes)[0] if used else _as_bytes(x)
        recv = _permute(send, src, dst, rank, group)
    if recv is None:
        return torch.zeros_like(x), used
    if not used:
        return recv.view(x.dtype), used
    with _stage("decode", x, call):
        return _decode(recv[None], x.dtype, n, prob_bits)[0], used


def compressed_reduce_scatter(
    x: torch.Tensor, group=None, budget_bytes: int | None = None,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """Reduce-scatter with on-the-fly float compression: rank d gets the sum
    over ranks s of chunk d of their x ((V,), V divisible by the world
    size), added in f32 in rank order and cast to x.dtype.

    Returns ((V / world,) x.dtype; used_compression bool).
    """
    group = resolve_group(group)
    _check(x, group, "compressed_reduce_scatter", 1)
    world = dist.get_world_size(group)
    if x.shape[0] % world:
        raise ValueError("compressed_reduce_scatter: V must be divisible by the world size")
    chunk = x.shape[0] // world
    if budget_bytes is None:
        budget_bytes = default_budget_bytes(chunk, x.element_size())
    recv, used = _chunk_exchange(x.reshape(world, chunk), group, budget_bytes, prob_bits)
    acc = recv[0].to(torch.float32)
    for row in recv[1:]:
        acc.add_(row)  # in f32: the bf16/f16 row is widened exactly
    return acc.to(x.dtype), used


def compressed_all_reduce(
    x: torch.Tensor, group=None, budget_bytes: int | None = None,
    prob_bits: int = C.DEFAULT_PROB_BITS,
):
    """All-reduce with compression on both wire phases: the compressed
    reduce-scatter, then the compressed all-gather of the reduced chunks.

    Returns ((V,) x.dtype, the full sum on every rank; used_compression
    bool, True where both phases moved compressed bytes).
    """
    shard, used_rs = compressed_reduce_scatter(x, group, budget_bytes, prob_bits)
    full, used_ag = compressed_all_gather(shard, group, budget_bytes, prob_bits)
    return full, used_rs and used_ag
