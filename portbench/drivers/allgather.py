"""The compressed all-gather cell: FSDP gathering a decoder layer's weights.

Every rank holds its shard of each of the model's layers (the layer's
parameters flattened in module order and cut into `world` equal shards, as
FSDP's FULL_SHARD cuts a unit), made on its card from the seed. Each rank
calls ``compressed_all_gather`` on its shard of layer ``i mod layers``, one
call after another, each followed by a synchronize, for the window. Before
each call the ranks agree, with one all-reduce of a flag, whether the
window is still open, so that all make the same calls; that exchange lies
outside every call's time.

A call's time is the slowest rank's, from entering the call to the
synchronize after it; the 95th percentile is over every call of the window.
After the window, each rank holds the gathered layer of the last call on
each of a few layers drawn from the seed against the layer made again from
the seed, and computes its shard's archive size with the reference to
judge the vote. Rank 0 is the run's own process; ``portbench.launch``
starts and stops the others.
"""

import os
import statistics
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import device, inputs, launch, sut as sut_mod, trace, work
from ..reference import floatref
from .codec import FLOAT_TYPES

STORE_TIMEOUT_S = 300
PG_TIMEOUT_S = 240


def layer_params(cfg) -> list:
    """[(name, words, init)] of one layer, in module order."""
    return [(name, int(np.prod(shape)), init) for name, shape, init in cfg["layer"]]


def shard_words(cfg, world: int) -> int:
    total = sum(n for _, n, _ in layer_params(cfg))
    if total % world:
        raise ValueError("the layer's words do not cut into equal shards")
    return total // world


def make_shard(cfg, layer: int, rank: int, world: int, dev, seed: int) -> torch.Tensor:
    """Rank `rank`'s shard of layer `layer`: N(0, initializer_range^2)
    weights, norm weights 1 and biases 0, in one draw and a few fills."""
    S = shard_words(cfg, world)
    x = inputs.normal(S, inputs.DTYPES[cfg["dtype"]], 0.0, cfg["model"]["initializer_range"],
                      dev, seed, layer, rank)
    start = 0
    for _, n, init in layer_params(cfg):
        a, b = max(start, rank * S), min(start + n, (rank + 1) * S)
        if b > a and init != "normal":
            x[a - rank * S : b - rank * S] = {"ones": 1.0, "zeros": 0.0}[init]
        start += n
    return x


def sample_layers(seed: int, layers: int, k: int) -> list:
    rng = np.random.default_rng(inputs.sub_seed(seed, 1 << 20))
    return sorted(int(v) for v in rng.choice(layers, size=min(k, layers), replace=False))


def default_budget(shard_bytes: int) -> int:
    """The per-shard budget the call takes by default, as the port
    documents it: 0.75x raw plus 4096 bytes, to a multiple of 16."""
    return floatref.round_up(int(shard_bytes * 0.75) + 4096, 16)


def _cpu_list(text: str) -> list:
    """ "0-3,8" -> [0, 1, 2, 3, 8]"""
    out = []
    for part in text.strip().split(","):
        a, _, b = part.partition("-")
        out += range(int(a), int(b or a) + 1)
    return out


def _local_cpus(card: int):
    """The CPUs next to card `card` (its PCI device's local_cpulist), or
    None where the device does not say."""
    p = torch.cuda.get_device_properties(card)
    if getattr(p, "pci_bus_id", None) is None:
        return None
    path = (f"/sys/bus/pci/devices/{getattr(p, 'pci_domain_id', 0):04x}:{p.pci_bus_id:02x}:"
            f"{getattr(p, 'pci_device_id', 0):02x}.0/local_cpulist")
    try:
        with open(path) as f:
            return frozenset(_cpu_list(f.read()))
    except OSError:
        return None


def pin(rank: int, world: int, allowed: list) -> None:
    """Keep this rank's threads on CPUs of its own: the CPUs the run may
    use that lie next to its card, shared out evenly among the ranks whose
    cards lie next to the same ones, so that no two ranks' host work (the
    glue, NCCL's proxy threads) contend for a core."""
    near = [_local_cpus(r) or frozenset(allowed) for r in range(world)]
    mine = [c for c in allowed if c in near[rank]]
    peers = [r for r in range(world) if near[r] == near[rank]]
    share = len(mine) // len(peers)
    if share:
        i = peers.index(rank)
        os.sched_setaffinity(0, mine[i * share : (i + 1) * share])
        print(f"portbench: rank {rank} on CPUs {sorted(os.sched_getaffinity(0))}",
              file=sys.stderr, flush=True)


def rank_main(cell, rank, world, store, spec, t_start) -> dict:
    """One rank's part of a run; returns what rank 0 combines."""
    cfg, tr = cell.config, cell.traffic
    if spec["device"] == "cuda":
        pin(rank, world, spec["cpus"])
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, store=dist.PrefixStore("pg", store), rank=rank,
                            world_size=world, timeout=timedelta(seconds=PG_TIMEOUT_S))
    try:
        # the ranks agree on the window's end over the host, so that no
        # kernel of the harness runs on the cards
        host = dist.new_group(backend="gloo", timeout=timedelta(seconds=PG_TIMEOUT_S))
        return _rank_body(cell, cfg, tr, rank, world, spec, dev, host, t_start)
    finally:
        dist.destroy_process_group()


def _rank_body(cell, cfg, tr, rank, world, spec, dev, host, t_start):
    seed, layers = spec["seed"], cfg["model"]["n_layer"]
    sut = sut_mod.load(spec["sut"])
    shards = [make_shard(cfg, layer, rank, world, dev, seed) for layer in range(layers)]
    for _ in range(tr["warm_calls"]):
        sut.compressed_all_gather(shards[0])
    device.sync(dev)
    sample = sample_layers(seed, layers, tr["check_layers"])
    setup_s = None

    def start():  # every rank enters the window together, its profiler running
        nonlocal setup_s
        dist.barrier(group=host)
        setup_s = time.perf_counter() - t_start

    seconds = tr["trace_seconds"] if spec["trace"] else spec["seconds"]
    go = torch.ones(1, dtype=torch.int32)
    times, used, kept = [], [], {}
    with trace.Window("allgather", spec["trace"], before=start) as w:
        t0 = time.perf_counter()
        k = 0
        while True:
            go[0] = int(k < layers or time.perf_counter() - t0 < seconds)
            dist.all_reduce(go, op=dist.ReduceOp.MIN, group=host)
            if not int(go[0]):
                break
            layer = k % layers
            a = time.perf_counter()
            full, ok = sut.compressed_all_gather(shards[layer])
            device.sync(dev)
            times.append(time.perf_counter() - a)
            used.append(bool(ok))
            if layer in sample:
                kept[layer] = (k, full)
            k += 1
        device.sync(dev)
        wall = time.perf_counter() - t0
    peak = device.memory_peak(dev)
    t_check = time.perf_counter()

    S = shard_words(cfg, world)
    wrong, failed = 0, []
    kept_calls = {str(layer): k for layer, (k, _) in kept.items()}
    for layer, (k, full) in kept.items():
        bad = 0
        for r in range(world):
            want = make_shard(cfg, layer, r, world, dev, seed)
            got = full[r * S : (r + 1) * S] if full.numel() == world * S else None
            bad += want.numel() if got is None else int(
                (inputs.words(got) != inputs.words(want)).sum())
        wrong += bad
        if bad:
            failed.append(k)
    kept.clear()
    ft, pb = FLOAT_TYPES[cfg["dtype"]], cfg["prob_bits"]
    own = {str(layer): floatref.float_archive(inputs.words(shards[layer]), ft, pb).numel()
           for layer in sample}
    return {"rank": rank, "times": times, "used": used, "wrong": wrong, "failed": failed,
            "kept": kept_calls, "own_sizes": own, "setup_s": setup_s, "wall_s": wall,
            "memory_peak_bytes": peak,
            "check_s": time.perf_counter() - t_check,
            "forbidden": device.forbidden_modules(), "summary": w.summary}


def run(cell, seed, seconds, trace_on, sut_spec, dev, t_start) -> dict:
    """One run of the cell, this process as rank 0."""
    world = cell.chips
    if cell.traffic["world"] != world:
        raise ValueError("the mix's world differs from the cell's chips")
    if dev.type == "cuda":  # build the kernels once, before the ranks start
        build = getattr(sut_mod.load(sut_spec), "build", None)
        if build is not None:
            build()
    store = dist.TCPStore("127.0.0.1", 0, world, True, wait_for_workers=False,
                          timeout=timedelta(seconds=STORE_TIMEOUT_S))
    spec = {"cell": cell.spec(), "seed": seed, "seconds": seconds, "trace": trace_on,
            "sut": sut_spec, "device": dev.type, "store_timeout_s": STORE_TIMEOUT_S,
            "cpus": sorted(os.sched_getaffinity(0))}
    procs = launch.start_ranks(world, store.port, spec)
    try:
        results = [rank_main(cell, 0, world, store, spec, t_start)]
        results += launch.collect(store, procs, STORE_TIMEOUT_S)
        launch.finish(procs)
    except BaseException:
        launch.abort()
        raise
    return combine(cell, results)


def combine(cell, results) -> dict:
    cfg = cell.config
    world = len(results)
    calls = len(results[0]["times"])
    if any(len(r["times"]) != calls for r in results):
        raise RuntimeError("the ranks made different numbers of calls")
    per_call = [max(r["times"][k] for r in results) for k in range(calls)]
    r0 = results[0]
    S = shard_words(cfg, world)
    shard_bytes = S * inputs.DTYPES[cfg["dtype"]].itemsize
    budget = default_budget(shard_bytes)
    used = r0["used"]
    vote_wrong = sum(
        1 for layer, k in r0["kept"].items()
        if used[k] != all(r["own_sizes"][layer] <= budget for r in results))
    failed = {k for k in range(calls) if not used[k]}
    for r in results:
        failed.update(r["failed"])
    outcome = {
        "attempted": calls,
        "failed": len(failed),
        "end_to_end": {
            "allgather_ms_p95": {"value": float(np.percentile(per_call, 95)) * 1e3, "unit": "ms"},
            "allgather_GBps": {"value": world * shard_bytes * calls / r0["wall_s"] / 1e9,
                               "unit": "GB/s"},
            "setup_s": {"value": r0["setup_s"], "unit": "s"},
        },
        "checks": {
            "gathered_words_wrong": {"value": sum(r["wrong"] for r in results), "limit": 0},
            "raw_fallback_calls": {"value": sum(1 for u in used if not u), "limit": 0},
            "vote_wrong": {"value": vote_wrong, "limit": 0},
            "failed_calls": {"value": len(failed), "limit": 0},
        },
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in results),
        "check_s": max(r["check_s"] for r in results),
        "count": world,
        "forbidden": sorted({m for r in results for m in r["forbidden"]}),
        "trace": None,
    }
    if results[0]["summary"] is not None:
        # a shard's archive: the mean of the reference sizes of the sampled
        # layers' shards, all drawn from one distribution
        arcs = [statistics.mean(r["own_sizes"].values()) for r in results]
        least = sum(calls * work.least_seconds(work.allgather_codec_bytes(shard_bytes, a, arcs))
                    for a in arcs)
        s = [r["summary"] for r in results]
        outcome["trace"] = {
            "ctx": {"cell": cell.name, "allgather": {
                "calls": calls, "ranks": world, "least_s": least,
                "codec_device_s": sum(x["device_s"] - x["nccl_s"] for x in s),
                "nccl_s": sum(x["nccl_s"] for x in s),
                "busy_s": s[0]["busy_s"], "window_s": s[0]["window_s"]}},
            "busy_s": statistics.mean(x["busy_s"] for x in s),
            "window_s": s[0]["window_s"],
            "breakdown": {"device_ops": trace.top(s[0]["device_ops"]),
                          "idle_gaps": trace.top(s[0]["idle_gaps"])},
        }
    return outcome
