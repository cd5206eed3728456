"""The port's shard codec and compressed collectives against the JAX
package's (CPU, gloo).

One module-scoped fixture spawns one gloo world of 4 ranks
(``torch_port_dist_worker.py``, a file rendezvous in a temporary
directory) that runs every scenario once and saves each rank's outputs,
flags, auto budget and the archives it compressed to send. The JAX side
runs here, on ``make_mesh(4)`` (``make_mesh(2)`` for the subgroup) of the
conftest's 8-device CPU mesh, through the XLA route that
``tests/test_parallel.py`` uses. Rank r's output must equal row r of the
JAX output, its flag ``used[r]``, and each archive it sent (bytes [0,
size)) the JAX float codec's (or the shard codec's) archive of the same
words. Tolerance is 0 everywhere: the codec is lossless, the archive format
fixed, and the f32 sums of reduce-scatter and all-reduce add the same
bf16 values in the same order. The spawned world has a deadline: a 60 s
timeout on every wait inside it and 180 s for the whole, after which its
ranks are killed and the fixture fails.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dietgpu_tpu import constants as JC
from dietgpu_tpu import parallel as jpar
from dietgpu_tpu.floatcodec import codec as jcodec
from dietgpu_tpu.ref import ans_ref

import torch_port_dist_worker as W
from dietgpu_tpu_torch.parallel import initialize_process_group
from torch_port_helpers import cuda_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_dist_worker.py")
DEADLINE_S = 180
_DIST_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")

_JTYPES = {"bfloat16": jnp.bfloat16, "float16": jnp.float16, "float32": jnp.float32}
_FT = {"bfloat16": JC.FLOAT_TYPE_BFLOAT16, "float16": JC.FLOAT_TYPE_FLOAT16,
       "float32": JC.FLOAT_TYPE_FLOAT32}
_jcompress = jax.jit(jcodec.float_compress_padded, static_argnums=(2, 3, 4))

COLLECTIVE_CASES = [c for c, spec in W.CASES.items() if spec[0] != "shard"]
SHARD_CASES = [c for c, spec in W.CASES.items() if spec[0] == "shard"]


def _child_env():
    env = {k: v for k, v in os.environ.items() if k not in _DIST_ENV}
    env.update(PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's saved results, {name: array}, indexed by rank."""
    out = tmp_path_factory.mktemp("gloo_world")
    procs = []
    for r in range(W.WORLD):
        with open(out / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(r), str(W.WORLD), str(out / "rendezvous"),
                 str(out)],
                env=_child_env(), cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            ))
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo world did not finish within {DEADLINE_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        logs = "\n".join((out / f"rank{r}.log").read_text()[-3000:] for r in range(W.WORLD))
        pytest.fail(f"a rank failed: {[p.returncode for p in procs]}\n{logs}")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(W.WORLD)]


@pytest.fixture(scope="module")
def meshes():
    return {4: jpar.make_mesh(4), 2: jpar.make_mesh(2)}


def _jfloats(bits, dtype):
    return jax.lax.bitcast_convert_type(jnp.asarray(bits), _JTYPES[dtype])


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).reshape(-1)


def _archive(bits, dtype):
    """The JAX float codec's archive of one shard's words, bytes [0, size)."""
    n = bits.shape[0]
    padded = np.zeros(JC.round_up(n, JC.DEFAULT_BLOCK_SIZE), bits.dtype)
    padded[:n] = bits
    arc, size = _jcompress(jnp.asarray(padded), n, _FT[dtype], JC.DEFAULT_PROB_BITS, False)
    return np.asarray(arc)[: int(size)]


def _jax_case(case, meshes):
    """The JAX collective on the case's inputs: (outputs, row per rank of
    ranks_of(case); flags (or the auto budget) per rank; the words each rank
    compresses to send, a list per compress call of rows per member)."""
    kind, dtype, n, kw = W.CASES[case]
    bits = W.case_input(case)
    g = bits.shape[0]
    mesh = meshes[g]
    x = _jfloats(bits, dtype)
    if kind == "all_gather":
        out, used = jpar.compressed_all_gather(x, mesh, **kw)
        return out, np.asarray(used), [[[b] for b in bits]]
    if kind == "all_gather_auto":
        out, wire = jpar.compressed_all_gather_auto(x, mesh)
        return out, [wire] * g, [[[b] for b in bits]]
    if kind == "all_to_all":
        out, used = jpar.compressed_all_to_all(x, mesh, **kw)
        return out, np.asarray(used), [[list(b) for b in bits]]
    if kind == "ppermute":
        out, used = jpar.compressed_ppermute(x, mesh, **kw)
        return out, np.asarray(used), [[[b] for b in bits]]
    chunks = [list(b.reshape(g, -1)) for b in bits]
    if kind == "reduce_scatter":
        out, used = jpar.compressed_reduce_scatter(x, mesh, **kw)
        return out, np.asarray(used), [chunks]
    out, used = jpar.compressed_all_reduce(x, mesh, **kw)
    shards, _ = jpar.compressed_reduce_scatter(x, mesh, **kw)
    word = np.uint16 if dtype != "float32" else np.uint32
    reduced = np.asarray(jax.lax.bitcast_convert_type(shards, word))
    return out, np.asarray(used), [chunks, [[s] for s in reduced]]


@pytest.mark.parametrize("case", COLLECTIVE_CASES)
def test_collective_matches_jax(case, world, meshes):
    """Every rank's output, flag and sent archives against the JAX
    collective and the JAX float codec, bit for bit."""
    kind, dtype, n, kw = W.CASES[case]
    out, flags, sends = _jax_case(case, meshes)
    out = np.asarray(out)
    for i, r in enumerate(W.ranks_of(case)):
        res = world[r]
        np.testing.assert_array_equal(res[f"{case}__out"], _bytes(out[i]), err_msg=f"rank {r}")
        assert res[f"{case}__flag"] == flags[i], f"rank {r}"
        sent = sorted(k for k in res if k.startswith(f"{case}__sent"))
        assert len(sent) == sum(len(call[i]) for call in sends), f"rank {r}"
        for c, call in enumerate(sends):
            for m, words in enumerate(call[i]):
                np.testing.assert_array_equal(
                    res[f"{case}__sent{c}_{m}"], _archive(words, dtype),
                    err_msg=f"rank {r}, compress call {c}, member {m}")
    if "raw" in case:
        assert not any(world[r][f"{case}__flag"] for r in W.ranks_of(case))
    elif kind != "all_gather_auto":
        assert all(world[r][f"{case}__flag"] for r in W.ranks_of(case))


@pytest.mark.parametrize("case", SHARD_CASES)
def test_shard_codec_matches_jax(case, world, meshes):
    """shard_compress / shard_decompress against the JAX shard codec: each
    rank's archive is the JAX row (and, with its own table, the oracle's
    archive of its bytes), with shared stats all four carry one table, and
    the decode's bytes, size and ok flag are the JAX ones."""
    _, _, n, kw = W.CASES[case]
    data = W.case_input(case)
    lengths = np.array(W.SHARD_LENGTHS, np.int32)
    arcs, sizes = jpar.shard_compress(meshes[4], jnp.asarray(data), jnp.asarray(lengths), **kw)
    arcs, sizes = np.asarray(arcs), np.asarray(sizes)
    outs, osizes, ok = jpar.shard_decompress(
        meshes[4], jnp.asarray(arcs), jnp.asarray(np.array(W.SHARD_CAPACITIES, np.int32)), n)
    outs, osizes, ok = np.asarray(outs), np.asarray(osizes), np.asarray(ok)
    for r in range(W.WORLD):
        res = world[r]
        sent = res[f"{case}__sent0"]
        np.testing.assert_array_equal(sent, arcs[r, : sizes[r]], err_msg=f"rank {r}")
        if not kw["shared_stats"]:
            np.testing.assert_array_equal(sent, ans_ref.ans_encode(data[r, : lengths[r]]))
        np.testing.assert_array_equal(res[f"{case}__out"], outs[r], err_msg=f"rank {r}")
        assert res[f"{case}__size"] == osizes[r] == lengths[r]
        assert res[f"{case}__flag"] == ok[r]
    assert [bool(world[r][f"{case}__flag"]) for r in range(W.WORLD)] == [True, True, False, False]
    if kw["shared_stats"]:
        probs = [world[r][f"{case}__sent0"][32 : 32 + 512] for r in range(W.WORLD)]
        assert all(np.array_equal(p, probs[0]) for p in probs)


STAGES = ("compress", "vote", "exchange", "decode")


def _calls(spans):
    """{group name: [(call id, [stages in order])] in call order} of a
    rank's recorded collective spans ("<group>.<n> collective.<stage>")."""
    out = {}
    for entry in spans:
        call, name = str(entry).split(" ")
        group = call.rsplit(".", 1)[0]
        calls = out.setdefault(group, [])
        if not calls or calls[-1][0] != call:
            calls.append((call, []))
        calls[-1][1].append(name.removeprefix("collective."))
    return out


def test_collective_spans_share_a_call_id_across_ranks(world):
    """Each rank records the compress, vote, exchange and decode of its
    collectives; the n-th call on a group has the same id on every rank of
    it, and every call starts with its compress and vote."""
    calls = [_calls(world[r]["spans"]) for r in range(W.WORLD)]
    for r in range(W.WORLD):
        assert {s for c in calls[r].values() for _, stages in c for s in stages} == set(STAGES)
        for group, made in calls[r].items():
            assert [c for c, _ in made] == [f"{group}.{n}" for n in range(len(made))]
            assert all(stages[:2] == ["compress", "vote"] for _, stages in made)
    default = [c["0"] for c in calls]
    assert all([c for c, _ in d] == [c for c, _ in default[0]] for d in default)
    sub = [calls[r] for r in W.SUBGROUP]
    assert [set(c) - {"0"} for c in sub][0] == [set(c) - {"0"} for c in sub][1] != set()
    assert not set(calls[0]) - {"0"} and not set(calls[2]) - {"0"}


def test_repeated_source_or_destination_is_refused(world):
    for r in range(W.WORLD):
        for i in range(len(W.BAD_PERMS)):
            assert "twice a source or a destination" in str(world[r][f"bad_perm{i}"])


def test_tensor_off_the_backends_device_is_refused(world):
    """A tensor whose device the group's backend does not serve raises, on
    every rank (a meta tensor on the gloo group; the card's cases are in the
    test marked gpu)."""
    for r in range(W.WORLD):
        assert "meta tensor on a gloo group" in str(world[r]["meta_device"])


def test_initialize_without_arguments_or_environment_is_single_process(monkeypatch):
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    assert initialize_process_group() is False
    assert not torch.distributed.is_initialized()


def test_initialize_nccl_without_a_card_names_gloo(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        initialize_process_group(init_method=f"file://{tmp_path}/rdv", world_size=1, rank=0)
    assert not torch.distributed.is_initialized()


def _run(code, tmp_path, timeout):
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code), str(tmp_path)], capture_output=True,
        text=True, env=_child_env(), cwd=REPO, timeout=timeout,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("OK"), out.stdout[-2000:]


def test_import_hygiene_world_one_gloo(tmp_path):
    """dietgpu_tpu_torch.parallel imports neither jax nor dietgpu_tpu, and
    runs a world-1 gloo all-gather and shard codec with both blocked."""
    _run(
        """
        import sys
        from datetime import timedelta

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "dietgpu_tpu"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import torch
        import torch.distributed as dist
        from dietgpu_tpu_torch import parallel

        assert parallel.initialize_process_group(
            backend="gloo", init_method=f"file://{sys.argv[1]}/rdv", world_size=1, rank=0,
            timeout=timedelta(seconds=60))
        x = torch.randn(5000, generator=torch.Generator().manual_seed(1)).bfloat16()
        full, used = parallel.compressed_all_gather(x)
        assert used and torch.equal(full, x)
        data = (x.float().abs() * 20).to(torch.uint8)[:4096]
        arc, size = parallel.shard_compress(data, 4096, shared_stats=True)
        out, osize, ok = parallel.shard_decompress(arc, 4096, 4096)
        assert bool(ok) and int(osize) == 4096 and torch.equal(out, data)
        dist.destroy_process_group()
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "dietgpu_tpu")]
        print("OK")
        """,
        tmp_path, timeout=120,
    )


@pytest.mark.gpu
def test_nccl_world_one_matches_the_gloo_cpu_route(cuda_device, tmp_path):
    """On the card: NCCL at world size 1 (one card; NCCL puts no two ranks
    of a communicator on one device). The all-gather and all-to-all give
    the gloo CPU route's outputs, flags and sent archives, and a tensor on
    the other backend's device raises."""
    _run(
        """
        import sys
        from datetime import timedelta

        import torch
        import torch.distributed as dist
        from dietgpu_tpu_torch import parallel
        from dietgpu_tpu_torch.parallel import collectives

        sent = []
        compress = collectives._compress

        def recording(x, prob_bits):
            arcs, sizes = compress(x, prob_bits)
            sent.append([arcs[m, : s // 4].cpu() for m, s in enumerate(sizes.tolist())])
            return arcs, sizes

        collectives._compress = recording
        assert parallel.initialize_process_group(
            init_method=f"file://{sys.argv[1]}/rdv", world_size=1, rank=0,
            timeout=timedelta(seconds=120))
        gloo = dist.new_group(backend="gloo")
        g = torch.Generator().manual_seed(3)
        for n in (4096, 5000):
            x = torch.randn(n, generator=g).bfloat16()
            calls = [
                (parallel.compressed_all_gather, x, {}),
                (parallel.compressed_all_gather, x, {"budget_bytes": 1024}),
                (parallel.compressed_all_to_all, x[None], {}),
            ]
            for fn, t, kw in calls:
                sent.clear()
                card, used_card = fn(t.cuda(), **kw)
                cpu, used_cpu = fn(t, group=gloo, **kw)
                assert used_card == used_cpu == ("budget_bytes" not in kw)
                assert torch.equal(card.cpu(), cpu) and torch.equal(cpu.reshape(-1), t.reshape(-1))
                assert all(torch.equal(a, b) for a, b in zip(sent[0], sent[1]))
        for fn, t, group in ((parallel.compressed_all_gather, x, None),
                             (parallel.compressed_all_gather, x.cuda(), gloo)):
            try:
                fn(t, group=group)
            except ValueError:
                continue
            raise AssertionError("a tensor on the wrong device for its group was taken")
        dist.destroy_process_group()
        print("OK")
        """,
        tmp_path, timeout=600,
    )
