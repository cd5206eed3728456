"""One rank of the gloo world that tests/test_torch_port_parallel.py spawns.

Run as ``python torch_port_dist_worker.py RANK WORLD RENDEZVOUS_FILE OUT_DIR``
with the repository on PYTHONPATH. Every rank joins one gloo process group
through the file rendezvous, runs every scenario of :data:`CASES` through
``dietgpu_tpu_torch.parallel`` on CPU tensors, and saves to
``OUT_DIR/rank<RANK>.npz``, for each case, its output bytes, its flag (or
auto budget), every archive it compressed to send, and the collective
spans it recorded (call id and stage, in the order they ended); on an
error it
writes the traceback to ``OUT_DIR/rank<RANK>.err``. Imports only torch,
numpy and the port. The test process imports :func:`case_input` from here,
so both sides see the same numpy inputs.
"""

import os
import sys
import traceback
import zlib
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
SEED = 0x5EED
SUBGROUP = (1, 3)
# case -> (collective, dtype, words a shard (or chunk), keyword arguments);
# the subgroup cases run on SUBGROUP
CASES = {
    "shard": ("shard", "uint8", 8192, {"shared_stats": False}),
    "shard_shared_stats": ("shard", "uint8", 8192, {"shared_stats": True}),
    "all_gather_bf16_5000": ("all_gather", "bfloat16", 5000, {}),
    "all_gather_bf16_8192": ("all_gather", "bfloat16", 8192, {}),
    "all_gather_f16_4096": ("all_gather", "float16", 4096, {}),
    "all_gather_f32_4096": ("all_gather", "float32", 4096, {}),
    "all_gather_bf16_5000_raw": ("all_gather", "bfloat16", 5000, {"budget_bytes": 1024}),
    "all_gather_bf16_8192_raw": ("all_gather", "bfloat16", 8192, {"budget_bytes": 1024}),
    "all_gather_f16_4096_raw": ("all_gather", "float16", 4096, {"budget_bytes": 1024}),
    "all_gather_f32_4096_raw": ("all_gather", "float32", 4096, {"budget_bytes": 1024}),
    # the last rank's words are uniformly random bits, past any budget: its
    # overflow alone must send every rank down the raw path
    "all_gather_bf16_8192_one_rank_raw": ("all_gather", "bfloat16", 8192, {}),
    "all_to_all_bf16_8192_one_rank_raw": ("all_to_all", "bfloat16", 8192, {}),
    "all_gather_auto_bf16_8192": ("all_gather_auto", "bfloat16", 8192, {}),
    "all_to_all_bf16_4096": ("all_to_all", "bfloat16", 4096, {}),
    "all_to_all_f32_4096": ("all_to_all", "float32", 4096, {}),
    "reduce_scatter_bf16": ("reduce_scatter", "bfloat16", WORLD * 4096, {}),
    "all_reduce_bf16": ("all_reduce", "bfloat16", WORLD * 4096, {}),
    "ppermute_ring": ("ppermute", "bfloat16", 8192, {}),
    "ppermute_partial": ("ppermute", "bfloat16", 4096, {"perm": [(0, 3), (1, 2)]}),
    "ppermute_partial_raw": (
        "ppermute", "bfloat16", 4096, {"perm": [(0, 3), (1, 2)], "budget_bytes": 16}),
    "ppermute_self_edge": (
        "ppermute", "bfloat16", 4096, {"perm": [(0, 0), (1, 2), (2, 3), (3, 1)]}),
    "subgroup_all_gather": ("all_gather", "bfloat16", 5000, {}),
    "subgroup_ppermute_ring": ("ppermute", "bfloat16", 4096, {}),
}
SHARD_LENGTHS = (8192, 6000, 4097, 1)  # rank r's byte count
SHARD_CAPACITIES = (8192, 8192, 4096, 0)  # rank r's shard_decompress capacity
# perms that compressed_ppermute must refuse: a repeated source, a
# repeated destination
BAD_PERMS = ([(0, 1), (0, 2)], [(0, 1), (2, 1)])


def ranks_of(case):
    return SUBGROUP if case.startswith("subgroup") else tuple(range(WORLD))


def case_input(case):
    """The case's input for every rank, from a seed: (ranks, ...) uint8
    bytes for the shard codec, else the float words' bit patterns (uint16
    for f16/bf16, uint32 for f32); row i is what ranks_of(case)[i] holds.
    Shapes: (ranks, n) for all-gather, ppermute, reduce-scatter and
    all-reduce; (ranks, ranks, n) for all-to-all, row [s, d] going from s
    to d."""
    kind, dtype, n, _ = CASES[case]
    rng = np.random.default_rng([SEED, zlib.crc32(case.encode())])
    g = len(ranks_of(case))
    if kind == "shard":
        # bytes past each rank's length stay random: the codec must ignore them
        return np.minimum(rng.exponential(30, (g, n)), 255).astype(np.uint8)
    x = rng.standard_normal((g, g, n) if kind == "all_to_all" else (g, n)).astype(np.float32)
    if dtype == "bfloat16":
        bits = (x.view(np.uint32) >> 16).astype(np.uint16)
    elif dtype == "float16":
        bits = x.astype(np.float16).view(np.uint16)
    else:
        bits = x.view(np.uint32)
    if case.endswith("one_rank_raw"):
        bits[-1] = rng.integers(0, 1 << 16, bits.shape[1:], dtype=np.uint16)
    return bits


_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _floats(bits, dtype):
    """numpy bit patterns -> a torch float tensor of `dtype`."""
    signed = bits.view(np.int16 if bits.dtype == np.uint16 else np.int32)
    return torch.from_numpy(signed.copy()).view(_TORCH[dtype])


def _bytes(t):
    return t.contiguous().view(torch.uint8).reshape(-1).numpy().copy()


def run_case(case, rank, group, sent, res):
    from dietgpu_tpu_torch import parallel

    kind, dtype, n, kw = CASES[case]
    row = ranks_of(case).index(rank)
    x = case_input(case)[row]
    if kind == "shard":
        data = torch.from_numpy(x.copy())
        arc, size = parallel.shard_compress(data, SHARD_LENGTHS[rank], group, **kw)
        size = int(size)
        res[f"{case}__sent0"] = _bytes(arc)[:size]
        out, osize, ok = parallel.shard_decompress(arc, SHARD_CAPACITIES[rank], n, group)
        res[f"{case}__out"] = out.numpy().copy()
        res[f"{case}__size"] = np.array(int(osize))
        res[f"{case}__flag"] = np.array(bool(ok))
        return
    fn = {
        "all_gather": parallel.compressed_all_gather,
        "all_gather_auto": parallel.compressed_all_gather_auto,
        "all_to_all": parallel.compressed_all_to_all,
        "reduce_scatter": parallel.compressed_reduce_scatter,
        "all_reduce": parallel.compressed_all_reduce,
        "ppermute": parallel.compressed_ppermute,
    }[kind]
    sent.clear()
    out, flag = fn(_floats(x, dtype), group=group, **kw)
    res[f"{case}__out"] = _bytes(out)
    res[f"{case}__flag"] = np.array(flag)
    for i, (arcs, sizes) in enumerate(sent):
        for m, s in enumerate(sizes.tolist()):
            res[f"{case}__sent{i}_{m}"] = _bytes(arcs[m])[: s & 0x7FFFFFFF]


def main(rank, world, rendezvous, out_dir):
    torch.set_num_threads(1)
    from dietgpu_tpu_torch import parallel, profiling
    from dietgpu_tpu_torch.parallel import collectives

    # record every archive the collectives compress to send
    sent = []
    compress = collectives._compress

    def recording(x, prob_bits):
        arcs, sizes = compress(x, prob_bits)
        sent.append((arcs, sizes))
        return arcs, sizes

    collectives._compress = recording
    assert parallel.initialize_process_group(
        backend="gloo", init_method=f"file://{rendezvous}", world_size=world, rank=rank,
        timeout=timedelta(seconds=60),
    )
    res = {}
    try:
        sub = parallel.make_group(SUBGROUP)  # every rank takes part in new_group
        with profiling.record_spans() as rec:
            for case in CASES:
                if rank in ranks_of(case):
                    run_case(case, rank, sub if case.startswith("subgroup") else None, sent,
                             res)
        res["spans"] = np.array([f"{s['call']} {s['name']}" for s in rec.spans()
                                 if s["name"].startswith("collective.")])
        for i, perm in enumerate(BAD_PERMS):
            try:
                parallel.compressed_ppermute(torch.zeros(4096, dtype=torch.bfloat16), perm)
            except ValueError as e:
                res[f"bad_perm{i}"] = np.array(str(e))
        try:
            parallel.compressed_all_gather(torch.empty(4096, dtype=torch.bfloat16, device="meta"))
        except ValueError as e:
            res["meta_device"] = np.array(str(e))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.tmp.npz"), **res)
    os.replace(os.path.join(out_dir, f"rank{rank}.tmp.npz"),
               os.path.join(out_dir, f"rank{rank}.npz"))


if __name__ == "__main__":
    r, w, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    try:
        main(r, w, rdv, out)
    except BaseException:
        with open(os.path.join(out, f"rank{r}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
