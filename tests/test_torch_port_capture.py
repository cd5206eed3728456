"""The port's codec entry points under a CUDA graph capture.

The entry points copy nothing from pageable memory and read nothing back,
so that ``torch.cuda.graph`` captures them as ``jax.jit`` compiles the JAX
package's: scalars are device fills, and what B host ints define (a ragged
batch's lengths and offsets, the ANS section words) is a read-only
``layout.device_constant`` that the first call with those ints makes.

On the CPU:

- the geometry those constants hold, against the numpy geometry that
  ``write_sections_batched`` and ``_compress_batched`` built before them,
  for equal, ragged and zero lengths, B = 1 and B = 65537;
- two calls with the same lengths and different data, each held against
  the JAX package through the helpers of ``test_torch_port_parity.py``,
  with every cached constant unchanged by the second call;
- ``normalize_probs`` with an int total and a Python K, bit for bit as
  with tensors, and against the JAX package;
- the cache's bound.

The tests marked `gpu` capture every entry point at a small size, with and
without the checksum, for equal and ragged lengths and B = 1 and B > 1,
after an eager warm-up under ``torch.cuda.set_sync_debug_mode("error")``,
and hold each replay against an eager call on the same input, bit for bit;
a captured compress records each of its kernels once, the tables and
sections kernels included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dietgpu_tpu.ans import stats as jstats

import dietgpu_tpu_torch as port
from dietgpu_tpu_torch import api as papi
from dietgpu_tpu_torch import constants as C
from dietgpu_tpu_torch.ans import encode as pencode
from dietgpu_tpu_torch.ans import layout, stats
from dietgpu_tpu_torch.floatcodec import codec, cuda_float
from test_torch_port_parity import BF16, F32, FLOAT_LENS, FRONTS, RAW_SIZES, compress, \
    exp_bytes, normal
from torch_port_helpers import cuda_device  # noqa: F401

BF = C.FLOAT_TYPE_BFLOAT16
FP32 = C.FLOAT_TYPE_FLOAT32
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the geometry, against the numpy geometry the host copies carried
# ---------------------------------------------------------------------------


def numpy_sections(lengths, base32, prob_bits, use_checksum):
    """The (12, B) head that write_sections_batched copied to the device
    before the cache: header words with the total and checksum 0, then the
    payload and blockWords offsets, the bytes before the payload, the
    archive offsets."""
    lengths = np.asarray(lengths, np.int64)
    base = np.broadcast_to(np.asarray(base32, np.int64), lengths.shape)
    nbs = -(-lengths // C.DEFAULT_BLOCK_SIZE)
    st32 = base + 136
    bw32 = st32 + nbs * C.NUM_INTERLEAVED
    ds32 = bw32 + 2 * (nbs + (nbs & 1))
    head = np.zeros((12, len(lengths)), np.int64)
    head[0] = (C.ANS_MAGIC << 16) | C.ANS_VERSION
    head[1], head[2] = nbs, lengths
    head[4] = prob_bits | (int(use_checksum) << 4)
    head[8], head[9], head[10], head[11] = ds32, bw32, 4 * (ds32 - base), base
    return head


def numpy_float(lengths, float_type, use_checksum):
    """The (6, B) geometry that _compress_batched copied for a ragged batch
    before the cache: the four header words, the lengths, the archive
    offsets."""
    lens = np.asarray(lengths, np.int64)
    base = 4 + (lens + 15) // 16 * 4
    if float_type == FP32:
        base += (lens + 7) // 8 * 4
    header = np.zeros((4, len(lens)), np.int64)
    header[0] = (C.FLOAT_MAGIC << 16) | C.FLOAT_VERSION
    header[1] = lens
    header[2] = (float_type & 0xF) | (int(use_checksum) << 4)
    return np.concatenate([header, lens[None], base[None]])


LENGTHS = {
    "equal": [5000] * 3,
    "ragged": [12000, 4096, 9001],
    "zero_members": [0, 4096, 0, 1],
    "B1": [9001],
    "B65537": np.random.default_rng(7).integers(0, 3 * 4096, 65537).tolist(),
}
GEOMETRY = [(name, ft, ck) for name in LENGTHS for ft in (BF, FP32) for ck in (False, True)]


@pytest.mark.parametrize("name,ft,ck", GEOMETRY,
                         ids=[f"{n}-ft{ft}-ck{int(ck)}" for n, ft, ck in GEOMETRY])
def test_device_geometry_matches_the_host_copies(name, ft, ck):
    lengths = LENGTHS[name]
    pb = 9 + len(name) % 3
    want = numpy_float(lengths, ft, ck)
    got = codec.ragged_geometry(lengths, ft, ck, CPU)
    np.testing.assert_array_equal(got[:4].numpy(), want[:4])
    np.testing.assert_array_equal(got[1].numpy(), want[4])  # the lengths the kernels take
    np.testing.assert_array_equal(got[4].numpy(), want[5])
    base = want[5]
    for base32 in (0, base.tolist()):  # raw archives at 0, float ones past their planes
        np.testing.assert_array_equal(
            pencode.section_geometry(lengths, base32, pb, ck, CPU).numpy(),
            numpy_sections(lengths, base32, pb, ck))


@pytest.mark.parametrize("lengths", [[5000] * 3, [12000, 4096, 9001], [0, 4096, 0]],
                         ids=["equal", "ragged", "zero_members"])
@pytest.mark.parametrize("ft", [BF, FP32], ids=["bf16", "f32"])
def test_header_words_match_the_host_copies(lengths, ft):
    """The header that the equal-length path now writes as fills, and the
    ragged path from its constant, are the words the host copy wrote."""
    Lw = C.round_up(max(lengths), C.DEFAULT_BLOCK_SIZE)
    rng = np.random.default_rng(2)
    dtype = torch.int32 if ft == FP32 else torch.int16
    words = torch.from_numpy(rng.integers(-30000, 30000, (len(lengths), Lw))).to(dtype)
    for ck in (False, True):
        arcs, _ = port.float_compress_batched(words, lengths, ft, 10, ck)
        header = layout.to_u32(arcs[:, :4]).T.numpy()
        want = numpy_float(lengths, ft, ck)[:4]
        np.testing.assert_array_equal(header[:3], want[:3])
        if not ck:
            np.testing.assert_array_equal(header[3], 0)


# ---------------------------------------------------------------------------
# the same lengths twice, different data: against the JAX package, and no
# cached constant written
# ---------------------------------------------------------------------------


def snapshot():
    return {k: t.clone() for k, (t, _) in layout._cache.items()}


REPEATS = [
    ("bf16_ragged", True, lambda seed: [normal(n, BF16, seed + i) for i, n in enumerate(FLOAT_LENS)]),
    ("f32_ragged", True, lambda seed: [normal(n, F32, seed + i) for i, n in enumerate(FLOAT_LENS)]),
    ("bf16_equal", True, lambda seed: [normal(12000, BF16, seed + i) for i in range(2)]),
    ("raw_ragged", False, lambda seed: [exp_bytes(n, seed + i) for i, n in enumerate(RAW_SIZES)]),
]


@pytest.mark.parametrize("ck", [False, True], ids=["ck0", "ck1"])
@pytest.mark.parametrize("name,ca,make", REPEATS, ids=[r[0] for r in REPEATS])
def test_same_lengths_twice_match_jax(name, ca, make, ck):
    jside, pside = FRONTS["api"]
    first = make(0)
    assert compress(pside, ca, first, ck) == compress(jside, ca, first, ck)
    before = snapshot()
    second = make(100)
    assert compress(pside, ca, second, ck) == compress(jside, ca, second, ck)
    after = snapshot()
    for k, t in before.items():
        if k in after:
            assert torch.equal(after[k], t), f"cached constant {k[1][0]} was written"


# ---------------------------------------------------------------------------
# normalize_probs: an int total becomes a fill, K a Python float
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pb", [9, 10, 11])
def test_normalize_probs_python_scalars_are_bit_exact(pb):
    rng = np.random.default_rng(pb)
    hists = [rng.integers(0, 1 << 20, 256), np.bincount(exp_bytes(12345, 1), minlength=256),
             np.eye(256, dtype=np.int64)[7] * 5, np.zeros(256, np.int64),
             (rng.random(256) < 0.05) * rng.integers(1, 1 << 24, 256)]
    for h in hists:
        h = torch.from_numpy(np.asarray(h, np.int64))
        total = int(h.sum())
        got = stats.normalize_probs(h, total, pb)
        assert torch.equal(got, stats.normalize_probs(h, torch.tensor(total), pb))
        want = jstats.normalize_probs(jnp.asarray(h.numpy(), jnp.uint32), total, pb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.sum()) == (0 if total == 0 else 1 << pb)
    # the product by a Python K rounds as the product by a float32 K, at
    # every ratio the quantization can see
    ratio = torch.from_numpy(np.concatenate([
        rng.random(1 << 16, np.float32), np.float32([0, 1, 2.0**-24, 1 - 2.0**-24]),
        (np.arange(1, 4097, dtype=np.float32) / 4096)]))
    k32 = torch.tensor(float(1 << pb), dtype=torch.float32)
    assert torch.equal((ratio * float(1 << pb)).to(torch.int64), (k32 * ratio).to(torch.int64))


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def test_cache_makes_once_and_keeps_a_bounded_number():
    made = []

    def make(i):
        made.append(i)
        return np.arange(3) + i

    key = ("test", "once")
    t = layout.device_constant(key, CPU, lambda: make(0))
    assert layout.device_constant(key, CPU, lambda: make(1)) is t and made == [0]
    for i in range(layout._CACHE_ENTRIES):
        layout.device_constant(("test", i), CPU, lambda i=i: make(i))
    assert (CPU, key) not in layout._cache  # the least recently used went
    assert len(layout._cache) <= layout._CACHE_ENTRIES
    np.testing.assert_array_equal(layout.device_constant(key, CPU, lambda: make(5)), np.arange(5, 8))


def test_ints_key_tells_equal_from_ragged():
    assert layout.ints_key([2, 5]) != layout.ints_key([5, 5])
    assert layout.ints_key([7] * 4) == ("all", 4, 7)
    assert layout.ints_key(np.array([1, 2])) == ("each", (1, 2))


# ---------------------------------------------------------------------------
# on the card: every entry point captured and replayed against eager calls
# ---------------------------------------------------------------------------


def capture_check(fn, static, inputs, view):
    """Warm fn(*static) up under the sync check, capture it, and for each
    input set copy it into `static`, replay, and hold view(outputs) against
    view(fn(*inputs)) bit for bit. Returns the launches the capture
    recorded; the replays must add none."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*static)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g = torch.cuda.CUDAGraph()
    port.reset_kernel_launches()
    with torch.cuda.graph(g):
        out = fn(*static)
    captured = port.kernel_launches()
    for xs in inputs:
        for s, x in zip(static, xs):
            s.copy_(x)
        g.replay()
        want = view(fn(*xs))
        torch.cuda.synchronize()
        got = view(out)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)
    port.reset_kernel_launches()
    g.replay()
    torch.cuda.synchronize()
    assert not any(port.kernel_launches().values()), "a replay counted a launch"
    return {k: v for k, v in captured.items() if v}


def archives_view(res):
    """Each row's archive [0, size) and the sizes, of (arcs, sizes)."""
    arcs, sizes = res
    arcs, sizes = (arcs[None], sizes[None]) if arcs.dim() == 1 else (arcs, sizes)
    rows = [arcs[m, : (s & 0x7FFFFFFF) // 4] for m, s in enumerate(sizes.tolist())]
    return [sizes, *rows]


def dict_view(res):
    return [res[k] for k in sorted(res)]


def float_words(dev, B, Lw, ft, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((B, Lw), np.float32))
    if ft == FP32:
        return x.view(torch.int32).to(dev)
    return (x.view(torch.int32) >> 16).to(torch.int16).view(torch.int32).to(dev)


def raw_bytes(dev, B, L, seed):
    return torch.from_numpy(np.stack([exp_bytes(L, seed + m) for m in range(B)])).to(dev)


CARD = [(ft, B, ragged, ck) for ft in (BF, FP32) for B, ragged in ((1, False), (3, False), (3, True))
        for ck in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("ft,B,ragged,ck", CARD,
                         ids=[f"ft{f}-B{b}-{'ragged' if r else 'equal'}-ck{int(c)}"
                              for f, b, r, c in CARD])
def test_float_codec_captures_on_card(cuda_device, ft, B, ragged, ck):
    Lw = 3 * C.DEFAULT_BLOCK_SIZE
    lengths = [Lw - 1000 * m - 7 for m in range(B)] if ragged else Lw - 5
    inputs = [(float_words(cuda_device, B, Lw, ft, s),) for s in range(3)]
    static = (inputs[0][0].clone(),)
    if B == 1 and not ragged:
        def comp(w):
            return port.float_compress_padded(w[0], lengths, ft, 10, ck)
    else:
        def comp(w):
            return port.float_compress_batched(w, lengths, ft, 10, ck)
    got = capture_check(comp, static, inputs, archives_view)
    want = {"split_f32" if ft == FP32 else "split": 1, "tables": 1, "encode": 1,
            "sections": 1, "assembly": 1}
    assert got == want
    arcs = [(comp(*x)[0].clone(),) for x in inputs]
    if B == 1 and not ragged:
        def dec(a):
            return port.float_decompress_padded(a, ft, Lw, 10, ck, static_length=lengths)
    else:
        def dec(a):
            return port.float_decompress_batched(a, ft, Lw, 10, ck)
    got = capture_check(dec, (arcs[0][0].clone(),), arcs, dict_view)
    assert got == {"decode_f32" if ft == FP32 else "decode": 1}


RAW = [(B, ragged, ck) for B, ragged in ((1, False), (3, False), (3, True)) for ck in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,ragged,ck", RAW,
                         ids=[f"B{b}-{'ragged' if r else 'equal'}-ck{int(c)}" for b, r, c in RAW])
def test_raw_codec_captures_on_card(cuda_device, B, ragged, ck):
    L = 3 * C.DEFAULT_BLOCK_SIZE
    lengths = [L - 999 * m - 1 for m in range(B)] if ragged else L - 3
    inputs = [(raw_bytes(cuda_device, B, L, 10 * s),) for s in range(3)]
    if B == 1 and not ragged:
        def comp(d):
            return port.ans_encode_padded(d[0], lengths, 10, ck)
    else:
        def comp(d):
            return port.ans_encode_batched(d, lengths, None, 10, ck)
    got = capture_check(comp, (inputs[0][0].clone(),), inputs, archives_view)
    assert got == {"hist": 1, "tables": 1, "encode": 1, "sections": 1, "assembly": 1}
    arcs = [(comp(*x)[0].clone(),) for x in inputs]
    if B == 1 and not ragged:
        def dec(a):
            return port.ans_decode_padded(a, 10, L, ck)
    else:
        def dec(a):
            return port.ans_decode_batched(a, 10, L, verify_checksum=ck)
    assert capture_check(dec, (arcs[0][0].clone(),), arcs, dict_view) == {"decode_raw": 1}


@pytest.mark.gpu
def test_given_pdfs_histogram_joins_and_info_capture_on_card(cuda_device):
    L = 2 * C.DEFAULT_BLOCK_SIZE
    data = [(raw_bytes(cuda_device, 2, L, s),) for s in range(3)]
    pdfs = stats.normalize_probs(torch.bincount(data[0][0][0].long(), minlength=256), L, 10)
    pdfs = torch.stack([pdfs, pdfs])
    assert capture_check(lambda d: port.ans_encode_batched(d, [L, L - 5], pdfs, 10),
                         (data[0][0].clone(),), data, archives_view) == {
        "tables": 1, "encode": 1, "sections": 1, "assembly": 1}
    for ck in (False, True):
        assert capture_check(lambda d: port.histogram_u8(d[0], L - 3, ck),
                             (data[0][0].clone(),), data,
                             lambda r: list(r) if ck else [r]) == {"hist": 1}
    planes = [cuda_float.split_words_batched_cuda(float_words(cuda_device, 2, L, BF, s), L, BF)
              for s in range(3)]
    assert capture_check(lambda e, c: port.join_words_packed(e, c, BF),
                         tuple(p.clone() for p in planes[0][:2]),
                         [p[:2] for p in planes], lambda r: [r]) == {"join": 1}
    planes = [cuda_float.split_words_f32_batched_cuda(float_words(cuda_device, 2, L, FP32, s), L)
              for s in range(3)]
    assert capture_check(lambda e, lo, hi: port.join_words_packed_f32(e, lo, hi),
                         tuple(p.clone() for p in planes[0][:3]),
                         [p[:3] for p in planes], lambda r: [r]) == {"join_f32": 1}
    arcs = [(port.ans_encode_batched(d, L, None, 10)[0].view(torch.uint8),) for (d,) in data]
    for ca in (False, True):
        assert capture_check(lambda a: papi.get_compressed_info_device(ca, a),
                             (arcs[0][0].clone(),), arcs, dict_view) == {}


@pytest.mark.gpu
def test_capture_without_warm_up_raises_on_card(cuda_device):
    """New ragged lengths inside a capture raise: there is no eager route."""
    words = float_words(cuda_device, 2, C.DEFAULT_BLOCK_SIZE, BF, 0)
    port.float_compress_batched(words, [4096, 4095], BF)  # the kernels are loaded
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside the capture"):
        with torch.cuda.graph(g):
            port.float_compress_batched(words, [4096, 4001], BF)
